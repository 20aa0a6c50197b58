"""Carry digests: a u32 position-weighted checksum of a tensor, on the
device and on the host.

The port of the digest half of the JAX package's ops/delta.py (the resident
state's row scatters are not ported). Float tensors are read as their raw
u32 bit patterns (NaN payloads and signed zeros included), ints and bools
are widened; element i is weighted by the odd constant 2i+1 and the
products are summed mod 2**32. `digest_fold` runs on the tensor's device
and `digest_fold_host` is its numpy twin: both give the same value, bit for
bit, as the reference's. `combine_digests` chains per-leaf digests in a
fixed order (FNV-1a over u32 words).

PyTorch has no general uint32 arithmetic, so the device fold works in int64
on 16-bit halves: u*w mod 2**32 = (lo*w + ((hi*w) mod 2**16) << 16) mod
2**32, with every partial product below 2**49 and the sum exact in int64.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


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
