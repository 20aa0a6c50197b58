"""The comparison that decides `correct`: a program's answer to one call
against the plain reference's.

The program's answer comes in as plain data (`Answer`): for each node, the
pods bound there in bind order as (workload, GPU index), and the pods
reported unschedulable as (workload, reason string). Replicas of one
workload differ only in their generated names, so pods are matched by
workload, node and order, never by name. Each number is a count of
disagreements, and every limit is 0:

  undecided      pods of the call the answer neither binds nor reports
                 (or reports twice), and pods on unknown nodes
  misplaced      pods whose node (or "unschedulable") differs
  bind_order     nodes whose sequence of bound pods differs
  gpu_index      pods on the right node with another GPU index
  reasons        unschedulable pods whose per-filter counts differ, or that
                 only one side reports
  allocation     nodes whose free resources after the call differ, each
                 node's free worked out from the answer's own binds
  overcommit     nodes where the answer's binds exceed a resource or a GPU
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .sched import EPS, MESSAGES, NONE, Result

LIMITS = {"undecided": 0, "misplaced": 0, "bind_order": 0, "gpu_index": 0,
          "reasons": 0, "allocation": 0, "overcommit": 0}
_MSG = {m: i for i, m in enumerate(MESSAGES)}


@dataclass
class Answer:
    """A program's result of one call, as plain data."""
    binds: Dict[str, List[Tuple[str, str]]] = field(default_factory=dict)
    unscheduled: List[Tuple[str, str]] = field(default_factory=list)


def parse_reason(reason: str, n_nodes: int) -> Optional[Tuple[int, ...]]:
    """'0/N nodes are available: 3 <message>, 1 <message>.' -> counts per
    filter, or None when the string is not of that form."""
    head = f"0/{n_nodes} nodes are available: "
    if not reason.startswith(head) or not reason.endswith("."):
        return None
    counts = [0] * NONE
    body = reason[len(head):-1]
    if body == "no nodes in cluster":
        return tuple(counts)
    for part in body.split(", "):
        num, _, msg = part.partition(" ")
        if msg not in _MSG or not num.isdigit():
            return None
        counts[_MSG[msg]] += int(num)
    return tuple(counts)


def _unmatched(a: Counter, b: Counter) -> int:
    return sum(b.values()) - sum((a & b).values())


def judge(ans: Answer, ref: Result) -> Dict[str, int]:
    """The numbers compared for one call (module docstring)."""
    names = ref.node_names
    index = {n: i for i, n in enumerate(names)}
    expected = len(ref.pods)
    out = dict.fromkeys(LIMITS, 0)

    # decisions
    decided = sum(len(v) for v in ans.binds.values()) + len(ans.unscheduled)
    out["undecided"] = abs(expected - decided) + sum(
        len(v) for k, v in ans.binds.items() if k not in index)

    # nodes per workload
    mine: Dict[str, Counter] = defaultdict(Counter)
    theirs: Dict[str, Counter] = defaultdict(Counter)
    for node, pods in ans.binds.items():
        for wl, _ in pods:
            mine[wl][node] += 1
    for wl, _ in ans.unscheduled:
        mine[wl][None] += 1
    for wl, n, _, _ in ref.pods:
        theirs[wl][names[n] if n >= 0 else None] += 1
    out["misplaced"] = sum(_unmatched(mine[wl], theirs[wl]) for wl in set(mine) | set(theirs))

    # bind order and GPU indices, node by node
    for i, node in enumerate(names):
        got, want = ans.binds.get(node, []), ref.binds[i]
        if got != want:
            out["bind_order"] += 1
        by_wl_got: Dict[str, Counter] = defaultdict(Counter)
        by_wl_want: Dict[str, Counter] = defaultdict(Counter)
        for wl, g in got:
            by_wl_got[wl][g] += 1
        for wl, g in want:
            by_wl_want[wl][g] += 1
        for wl in set(by_wl_got) & set(by_wl_want):
            a, b = by_wl_got[wl], by_wl_want[wl]
            same_node = min(sum(a.values()), sum(b.values()))
            out["gpu_index"] += same_node - sum((a & b).values())

    # failure reasons per workload
    got_r: Dict[str, Counter] = defaultdict(Counter)
    want_r: Dict[str, Counter] = defaultdict(Counter)
    for wl, reason in ans.unscheduled:
        got_r[wl][parse_reason(reason, len(names))] += 1
    for wl, n, _, counts in ref.pods:
        if n < 0:
            want_r[wl][counts] += 1
    out["reasons"] = sum(max(_unmatched(got_r[wl], want_r[wl]), _unmatched(want_r[wl], got_r[wl]))
                         for wl in set(got_r) | set(want_r))

    # the free resources the answer's binds leave, against the reference's
    for i, node in enumerate(names):
        free = ref.alloc[i].copy()
        gfree = ref.gpu_total[i].copy()
        for wl, g in ans.binds.get(node, []):
            req = ref.requests.get(wl)
            if req is None:
                continue
            free = free - req
            for d in (int(x) for x in g.split("-") if x != ""):
                if d < gfree.shape[0]:
                    gfree[d] = gfree[d] - ref.gpu_mem[wl]
                else:
                    gfree[:] = -np.inf
        if not (np.array_equal(free, ref.free[i]) and np.array_equal(gfree, ref.gpu_free[i])):
            out["allocation"] += 1
        if (free < -EPS).any() or (gfree < -EPS).any():
            out["overcommit"] += 1
    return out


def merge(parts: List[Dict[str, int]]) -> Dict[str, int]:
    """Sums of the numbers of several calls."""
    total = dict.fromkeys(LIMITS, 0)
    for p in parts:
        for k, v in p.items():
            total[k] += v
    return total
