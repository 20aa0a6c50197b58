"""Grouped scheduling helpers: runs of identical pods and their static parts.

For one pod template, the unschedulable / node-name / taint / node-affinity
masks and the node-affinity, taint, prefer-avoid and Simon scores do not
depend on the cluster state, so they are computed once per group.
"""

from __future__ import annotations

import hashlib
from dataclasses import fields
from typing import List, Tuple

import numpy as np
import torch

from .encode import PodBatch, round_up
from .kernels import (
    NUM_FILTERS,
    NodeStatic,
    PodRow,
    node_affinity_mask,
    score_node_affinity,
    score_prefer_avoid,
    score_simon,
    score_taint_toleration,
    taint_mask,
)


def _static_parts(ns: NodeStatic, pod: PodRow, weights, filter_on=None):
    """Masks/scores that do not depend on the carry. `filter_on`
    (bool[NUM_FILTERS] or None) disables filters per the scheduler profile;
    na_ok itself stays unmasked (spread eligibility reads the pod spec)."""
    unsched_tolerated = (
        pod.tol_valid
        & ((pod.tol_key == 0) | (pod.tol_key == ns.unsched_key_id))
        & (pod.tol_exists | (pod.tol_val == ns.empty_val_id))
        & ((pod.tol_effect == 0) | (pod.tol_effect == 1))
    ).any()
    na_ok = node_affinity_mask(ns, pod)
    static_fails = torch.stack(
        [
            ns.unsched & ~unsched_tolerated,
            (pod.node_name_id != 0) & (ns.name_id != pod.node_name_id),
            ~taint_mask(ns, pod),
            ~na_ok,
        ],
        dim=1,
    )                                                   # [N,4]
    if filter_on is not None:
        static_fails = static_fails & filter_on[None, :4]
    any_fail = static_fails.any(dim=1)
    # torch.argmax does not take bool on CUDA; on uint8 it still returns the
    # first failing filter, like jnp.argmax on the bool array
    first = static_fails.to(torch.uint8).argmax(dim=1).to(torch.int32)
    static_first_fail = torch.where(
        any_fail, first, torch.full_like(first, NUM_FILTERS)
    )
    static_scores = {
        "node_affinity": score_node_affinity(ns, pod),
        "taint_toleration": score_taint_toleration(ns, pod),
        "prefer_avoid_pods": score_prefer_avoid(ns, pod),
        "simon": score_simon(ns, pod),
    }
    return ~any_fail, static_first_fail, static_scores, na_ok


def _row_signature(batch: PodBatch) -> np.ndarray:
    """Byte-hash every pod row's feature arrays (blake2b) to detect
    identical specs."""
    parts = []
    for f in fields(batch):
        if f.name in ("keys", "valid"):
            continue
        arr = getattr(batch, f.name)
        parts.append(np.ascontiguousarray(arr).reshape(batch.p, -1).view(np.uint8))
    blob = np.concatenate(parts, axis=1)
    return np.array(
        [hashlib.blake2b(row.tobytes(), digest_size=8).digest() for row in blob]
    )


def group_runs(batch: PodBatch) -> List[Tuple[int, int]]:
    """(start, length) runs of consecutive identical valid rows."""
    total = int(batch.valid.sum())
    if total == 0:
        return []
    sig = _row_signature(batch)
    change = np.nonzero(sig[1:total] != sig[: total - 1])[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [total]))
    return [(int(s), int(e - s)) for s, e in zip(starts, ends)]


def _bucket(n: int) -> int:
    """Chunk-length bucket, floor 32."""
    return round_up(n, 32)
