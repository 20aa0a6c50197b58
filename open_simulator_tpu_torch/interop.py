"""Carry state across packages as numpy leaves.

Both packages use the same field names, dtypes and shapes for NodeStatic,
Carry and PodRow, so a dict of numpy arrays keyed by field name moves a whole
state between them without either importing the other.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .ops.kernels import Carry, NodeStatic, PodRow


def _tuple_from(cls, leaves: Dict[str, np.ndarray], dev: torch.device):
    missing = set(cls._fields) - set(leaves)
    if missing:
        raise KeyError(f"{cls.__name__} leaves missing: {sorted(missing)}")
    return cls(**{
        f: torch.from_numpy(np.array(leaves[f], copy=True)).to(dev)
        for f in cls._fields
    })


def from_jax_leaves(
    ns_np: Dict[str, np.ndarray],
    carry_np: Dict[str, np.ndarray],
    rows_np: Dict[str, np.ndarray],
    device=DEFAULT_DEVICE,
) -> Tuple[NodeStatic, Carry, PodRow]:
    """The port's (NodeStatic, Carry, PodRow) from the JAX package's leaves
    given as numpy arrays keyed by field name (e.g. `{f: np.asarray(v) for
    f, v in ns._asdict().items()}`)."""
    dev = resolve_device(device)
    return (
        _tuple_from(NodeStatic, ns_np, dev),
        _tuple_from(Carry, carry_np, dev),
        _tuple_from(PodRow, rows_np, dev),
    )


def to_host_leaves(state) -> Dict[str, np.ndarray]:
    """Numpy leaves of one of the port's state tuples, keyed by field name."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in state._fields}
