"""Tiling identical pods: encode one row per distinct workload template, then
replicate. Real workloads are a handful of templates × thousands of replicas
(the reference expands Deployments the same way, one synthesized pod per
replica of the same spec — utils.go:139-152), so this turns O(P) host work
into O(templates)."""

from __future__ import annotations

from dataclasses import fields, replace
from typing import List, Sequence

import numpy as np

from .encode import PodBatch, round_up


def tile_pod_batch(batch: PodBatch, counts: Sequence[int]) -> PodBatch:
    """Expand template batch rows by per-template replica counts.

    batch rows [0..len(counts)) are templates; returns a batch whose first
    sum(counts) rows are the replicas (template order preserved), padded to a
    bucket size.
    """
    t = len(counts)
    assert t <= batch.p
    total = int(sum(counts))
    P = round_up(total)
    reps = list(counts) + [0] * (batch.p - t)

    def grow(arr: np.ndarray) -> np.ndarray:
        tiled = np.repeat(arr[: batch.p], reps, axis=0)
        out = np.zeros((P,) + arr.shape[1:], arr.dtype)
        out[:total] = tiled
        return out

    keys: List[str] = []
    for i, c in enumerate(counts):
        base = batch.keys[i] if i < len(batch.keys) else f"tpl-{i}"
        keys.extend(f"{base}-{j}" for j in range(c))

    grown = {
        f.name: grow(getattr(batch, f.name))
        for f in fields(batch)
        if f.name != "keys"
    }
    return replace(batch, keys=keys, **grown)
