"""Shrunk copies of the cells' configurations and traffic for CPU tests:
the same generator and shapes, fewer nodes and pods."""

from __future__ import annotations

import copy

from simbench import gen


def config(name: str, nodes: int) -> dict:
    cfg = copy.deepcopy(gen.load("configs", name))
    spec = cfg["nodes"]
    spec["count"] = nodes
    if "types" in spec:
        first = max(1, nodes * spec["types"][0]["count"] // sum(t["count"] for t in spec["types"]))
        spec["types"][0]["count"] = first
        spec["types"][1]["count"] = nodes - first
    return cfg


def traffic(name: str, scale: float) -> dict:
    tr = copy.deepcopy(gen.load("traffic", name))
    tr["per_call"]["replicas"] = [max(1, int(r * scale)) for r in tr["per_call"]["replicas"]]
    tr["pods_per_call"] = sum(tr["per_call"]["replicas"])
    tr["route"] = None
    return tr
