"""The least time the domain_pop kernel could take for one launch.

Copied from chip_smoke.py:pop_bound, the count behind PERF.md's kernel
table (`bound_ms`). Bytes: the [Dc] and [C,*] tables read once, the
[Dc,L] head tables (score, node, lane) read only at the entries the loop
visits (each class's first head and one more per placed pod: Dc + placed
entries), both [G] outputs written once, at the HBM rate. Operations: the
f32 work of the pops that place a pod, at the f32 peak: per class the raw
increment, the spread norm (subtract, multiply, divide, two clips) and the
total (multiply, add); per hard row the D domain increments and per class
the count increment and the verdict (add, subtract, compare).

A launch is described by `Launch`: the element size and count of each of
the kernel's 14 tensor arguments in order (hscore, hnode, hj, cap_eff,
elig, combo_valid, base_dom, in_key, t_onehot, match, soft, hard, skew,
has_key), the number of classes Dc and domains D, the pops G, the hard
rows that count, and the pods it placed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .peaks import FP32_OPS_PER_S, HBM_BYTES_PER_S


@dataclass
class Launch:
    tensors: List[Tuple[int, int]]   # (element size, element count) per argument
    dc: int
    d: int
    g: int
    n_hard: int
    placed: int


def bytes_and_ops(x: Launch) -> Tuple[int, int]:
    head_bytes = (x.dc + x.placed) * sum(size for size, _ in x.tensors[:3])
    small_bytes = sum(size * count for size, count in x.tensors[3:])
    nbytes = head_bytes + small_bytes + 2 * 4 * x.g
    ops = (x.placed + 1) * (x.dc * 8 + x.n_hard * (x.d + 4 * x.dc))
    return nbytes, ops


def bound_s(x: Launch) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two floors."""
    nbytes, ops = bytes_and_ops(x)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
