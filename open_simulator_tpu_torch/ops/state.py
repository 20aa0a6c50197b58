"""Host -> device state plumbing: numpy tables -> tuples of torch tensors.

The whole cluster ships to the device once; what comes back per batch is the
placement vector, the failure-reason rows and the allocation takes. Every
field keeps the dtype and shape of the JAX package's NodeStatic/Carry/PodRow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .encode import (
    Encoder,
    NodeTable,
    PodBatch,
    anti_table_size,
    port_table_sizes,
    round_up,
    selector_table_size,
)
from .kernels import Carry, NodeStatic, PodRow


def _t(arr, dev: torch.device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        # a resident plane (engine/resident.table_view): a copy on its
        # device, so the carry never aliases the resident state
        return arr.to(dev).clone()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def anti_topo_array(enc: Encoder) -> np.ndarray:
    """i32[AT] topo-key index per registered required-anti-affinity term."""
    arr = np.full(anti_table_size(enc), -1, np.int32)
    for t, (k_idx, _sel) in enumerate(enc.anti_terms):
        arr[t] = k_idx
    return arr


def node_static_from_table(
    enc: Encoder, table: NodeTable, device=DEFAULT_DEVICE
) -> NodeStatic:
    dev = resolve_device(device)
    D = round_up(len(enc.domains) + 1, 4)
    domain_key = np.full(D, -1, np.int32)
    for did_minus1, k_idx in enumerate(enc.domain_topo):
        domain_key[did_minus1 + 1] = k_idx
    # one-hot domain membership per topology key [K,D,N]; key 0 (hostname)
    # is counted per node by the kernels and stays zero here
    K = table.topo.shape[1]
    topo_onehot = np.zeros((K, D, table.n), np.float32)
    for k in range(1, K):
        d = table.topo[:, k]
        rows = np.nonzero((d >= 0) & table.valid)[0]
        topo_onehot[k, d[rows], rows] = 1.0
    fields = {
        f: getattr(table, f) for f in NodeStatic._fields if hasattr(table, f)
    }
    return NodeStatic(
        **{f: _t(a, dev) for f, a in fields.items()},
        domain_key=_t(domain_key, dev),
        topo_onehot=_t(topo_onehot, dev),
        unsched_key_id=torch.tensor(enc.unsched_key_id, dtype=torch.int32, device=dev),
        empty_val_id=torch.tensor(enc.empty_val_id, dtype=torch.int32, device=dev),
        anti_topo=_t(anti_topo_array(enc), dev),
    )


def carry_from_table(
    table: NodeTable,
    sel_counts: Optional[np.ndarray] = None,
    num_selectors: int = 1,
    port_counts: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    anti_counts: Optional[np.ndarray] = None,
    device=DEFAULT_DEVICE,
) -> Carry:
    dev = resolve_device(device)
    if sel_counts is None:
        # the encoder's selector_table_size bucketing
        sel_counts = np.zeros(
            (round_up(max(num_selectors, 1), 8), table.n), np.float32
        )
    if port_counts is None:
        z = np.zeros((2, table.n), np.float32)
        port_counts = (z, z, z)
    if anti_counts is None:
        anti_counts = np.zeros((2, table.n), np.float32)  # anti_table_size min
    return Carry(
        free=_t(table.free, dev),
        sel_counts=_t(sel_counts, dev),
        gpu_free=_t(table.gpu_free, dev),
        vg_free=_t(table.vg_free, dev),
        dev_free=_t(table.dev_free, dev),
        port_any=_t(port_counts[0], dev),
        port_wild=_t(port_counts[1], dev),
        port_ipc=_t(port_counts[2], dev),
        anti_counts=_t(anti_counts, dev),
    )


def pod_rows_from_batch(batch: PodBatch, device=DEFAULT_DEVICE) -> PodRow:
    """Stacked PodRow ([P, ...] leaves); PodRow fields map 1:1 onto PodBatch
    attributes of the same name."""
    dev = resolve_device(device)
    return PodRow(**{f: _t(getattr(batch, f), dev) for f in PodRow._fields})


def _grow_rows(arr: torch.Tensor, rows: int) -> torch.Tensor:
    old, n = arr.shape
    if rows <= old:
        return arr
    out = torch.zeros((rows, n), dtype=arr.dtype, device=arr.device)
    out[:old] = arr
    return out


def align_carry(carry: Carry, enc: Encoder, ns: NodeStatic) -> Tuple[Carry, NodeStatic]:
    """Grow the selector/port/anti row axes when a later batch registered
    new entries, keeping the counts so far in place (ids are append-only),
    and refresh NodeStatic.anti_topo when its content is stale, not only its
    shape: the 0-term pad state and the 1-term state share shape (1,).
    Returns the same carry / ns objects when nothing changed."""
    pid, pip = port_table_sizes(enc)
    new = {
        "sel_counts": _grow_rows(carry.sel_counts, selector_table_size(enc)),
        "port_any": _grow_rows(carry.port_any, pid),
        "port_wild": _grow_rows(carry.port_wild, pid),
        "port_ipc": _grow_rows(carry.port_ipc, pip),
        "anti_counts": _grow_rows(carry.anti_counts, anti_table_size(enc)),
    }
    if any(v is not getattr(carry, k) for k, v in new.items()):
        carry = carry._replace(**new)
    want = anti_topo_array(enc)
    have = ns.anti_topo.cpu().numpy()
    if have.shape != want.shape or not np.array_equal(have, want):
        ns = ns._replace(anti_topo=_t(want, ns.anti_topo.device))
    return carry, ns


def stack_carry(carry: Carry, count: int) -> Carry:
    """Scenario-stacked Carry: every leaf gains a leading [S] axis holding
    `count` identical copies, the starting state of a multi-scenario sweep.

    Each leaf is a fresh dense copy (`repeat`, never a stride-0 `expand`
    view): the stacked carry shares no storage with `carry`, so a write to
    one lane touches neither the other lanes nor the source, which may be
    the simulator's live serial carry."""
    return Carry(*(a.unsqueeze(0).repeat((count,) + (1,) * a.dim()) for a in carry))


def _grow_rows_stacked(arr: torch.Tensor, rows: int) -> torch.Tensor:
    s, old, n = arr.shape
    if rows <= old:
        return arr
    out = torch.zeros((s, rows, n), dtype=arr.dtype, device=arr.device)
    out[:, :old] = arr
    return out


def align_carry_scenarios(
    carry_s: Carry, enc: Encoder, ns: NodeStatic
) -> Tuple[Carry, NodeStatic]:
    """align_carry for a scenario-stacked carry ([S, rows, N] leaves): grows
    the selector/port/anti row axes (axis 1) in lockstep across all lanes
    and refreshes NodeStatic.anti_topo as align_carry does. Returns the same
    objects when nothing changed."""
    pid, pip = port_table_sizes(enc)
    new = {
        "sel_counts": _grow_rows_stacked(carry_s.sel_counts, selector_table_size(enc)),
        "port_any": _grow_rows_stacked(carry_s.port_any, pid),
        "port_wild": _grow_rows_stacked(carry_s.port_wild, pid),
        "port_ipc": _grow_rows_stacked(carry_s.port_ipc, pip),
        "anti_counts": _grow_rows_stacked(carry_s.anti_counts, anti_table_size(enc)),
    }
    if any(v is not getattr(carry_s, k) for k, v in new.items()):
        carry_s = carry_s._replace(**new)
    want = anti_topo_array(enc)
    have = ns.anti_topo.cpu().numpy()
    if have.shape != want.shape or not np.array_equal(have, want):
        ns = ns._replace(anti_topo=_t(want, ns.anti_topo.device))
    return carry_s, ns
