"""Delta kernels of the resident cluster state (engine/resident.py), and
the u32 position-weighted digest of a tensor on the device and on the host.

The port of the JAX package's ops/delta.py.

`apply_rows` / `apply_flags` scatter freshly re-encoded rows into the
resident planes. Row *contents* are always recomputed on the host by the
exact encode_node_into code path, so the device work is pure data movement.
Index vectors are bucket-padded (`pad_indices`); a pad slot holds n, one past
the last row, and is dropped, never clamped: only the live slots are
scattered (the reference relies on XLA's scatter `mode="drop"`; PyTorch's
index_put_ would fail or, clamped, smash the last row). The reference
donates the plane; here the plane passed in is written in place and
returned, so the caller passes a fresh copy whenever a reader may still hold
the old one (engine/resident._apply_rows).

`digest_fold` reads float tensors as their raw u32 bit patterns (NaN
payloads and signed zeros included) and widens ints and bools; element i is
weighted by the odd constant 2i+1 and the products are summed mod 2**32. It
runs on the tensor's device and `digest_fold_host` is its numpy twin: both
give the same value, bit for bit, as the reference's. `combine_digests` chains per-leaf digests in a
fixed order (FNV-1a over u32 words).

PyTorch has no general uint32 arithmetic, so the device fold works in int64
on 16-bit halves: u*w mod 2**32 = (lo*w + ((hi*w) mod 2**16) << 16) mod
2**32, with every partial product below 2**49 and the sum exact in int64.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .encode import round_up

_MASK32 = 0xFFFFFFFF


def pad_indices(idx: Iterable[int], n: int) -> np.ndarray:
    """A host index list bucket-padded to i32[round_up(U, 8)]; pad slots
    hold n (one past the last row), which apply_rows drops."""
    raw = np.asarray(list(idx), np.int32)
    u = round_up(max(len(raw), 1), 8)
    out = np.full(u, n, np.int32)
    out[: len(raw)] = raw
    return out


def apply_rows(arr: torch.Tensor, idx: np.ndarray, rows: np.ndarray) -> torch.Tensor:
    """arr[idx[u]] = rows[u] for every live slot u (idx[u] < len(arr)); the
    pad slots are dropped. The live slots are picked on the host and only
    their rows travel. Writes into `arr` and returns it: the caller treats
    the plane it passed as consumed, as the reference's donation does."""
    live = idx < arr.shape[0]
    idx_t = torch.from_numpy(idx[live].astype(np.int64)).to(arr.device)
    rows_t = torch.from_numpy(np.ascontiguousarray(rows[live])).to(arr.device, arr.dtype)
    arr.index_put_((idx_t,), rows_t)
    return arr


def apply_flags(arr: torch.Tensor, idx: np.ndarray, vals: np.ndarray) -> torch.Tensor:
    """apply_rows for 1-D per-node vectors (flags, name ids); the same
    contract: `arr` is written and returned."""
    return apply_rows(arr, idx, vals)


def _bits_u32(x: torch.Tensor) -> torch.Tensor:
    """The u32 image of every element, held in int64."""
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    return x.to(torch.int64) & _MASK32


def digest_fold(x: torch.Tensor) -> torch.Tensor:
    """i64[] holding the u32 position-weighted checksum of `x`, computed on
    its device (one 8-byte scalar to fetch)."""
    u = _bits_u32(x).reshape(-1)
    w = (torch.arange(u.shape[0], dtype=torch.int64, device=u.device) * 2 + 1) & _MASK32
    lo = u & 0xFFFF
    hi = u >> 16
    part = (lo * w + (((hi * w) & 0xFFFF) << 16)) & _MASK32
    return part.sum() & _MASK32


def digest_fold_host(x: np.ndarray) -> int:
    """Bit-identical numpy twin of digest_fold for host arrays."""
    x = np.ascontiguousarray(x)
    if x.dtype == np.float32:
        u = x.view(np.uint32).ravel()
    else:
        u = x.astype(np.uint32).ravel()
    # all-uint32 arithmetic: numpy's multiply and sum both wrap mod 2**32
    w = np.arange(u.size, dtype=np.uint32) * np.uint32(2) + np.uint32(1)
    return int(np.sum(u * w, dtype=np.uint32))


def combine_digests(parts: Iterable[int]) -> int:
    """Chain per-leaf digests into one (FNV-1a over u32 words). Order
    matters: callers fold leaves in a fixed field order."""
    h = 2166136261
    for p in parts:
        h = ((h ^ (int(p) & _MASK32)) * 16777619) & _MASK32
    return h
