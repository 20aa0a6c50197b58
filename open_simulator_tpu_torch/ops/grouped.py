"""Grouped scheduling: runs of identical pods and their per-pod scan.

Real batches are a few templates x many replicas. For one template, the
unschedulable / node-name / taint / node-affinity masks and the
node-affinity, taint, prefer-avoid and Simon scores do not depend on the
cluster state, so they are computed once per group (`_static_parts`).
`schedule_group` then runs the per-pod step on the rest (resources, ports,
spread, inter-pod affinity, storage, GPU share), bit-identical to
`kernels.schedule_batch` because every dynamic quantity is recomputed
exactly as the oracle does.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import fields
from typing import List, Tuple

import numpy as np
import torch

from .. import native
from ..device import DEFAULT_DEVICE, resolve_device
from ..parallel import slots as nx
from .encode import PodBatch, round_up
from . import scanmark
from .sanitize import sanitizable
from .kernels import (
    Carry,
    F_EXTRA,
    F_GPU,
    F_NODE_PORTS,
    F_POD_AFFINITY,
    F_RESOURCES,
    F_SPREAD,
    F_STORAGE,
    NUM_FILTERS,
    NodeStatic,
    PodRow,
    _affinity_rows_ok,
    _anti_sym_ok,
    _affinity_score,
    _la_ba,
    _minmax_normalize,
    _spread_rows_ok,
    _spread_score,
    _storage_commit,
    combine_scores,
    first_failure,
    gpu_allocate,
    gpu_mask,
    local_storage_eval,
    node_affinity_mask,
    plugin_call,
    pod_keys,
    ports_commit,
    ports_mask,
    reason_row,
    resource_fail,
    score_gpu_share,
    score_node_affinity,
    score_prefer_avoid,
    score_simon,
    score_taint_toleration,
    static_fails,
)
from .state import pod_rows_from_batch

# Default cap on the pods one call of the per-pod scans takes (the
# reference bounds each device program's length with it; the port keeps the
# same chunking so every route splits a group where the reference does).
DEFAULT_GROUP_CHUNK = 16384


def _static_parts(ns: NodeStatic, pod: PodRow, weights, filter_on=None):
    """Masks/scores that do not depend on the carry. `filter_on`
    (bool[NUM_FILTERS] or None) disables filters per the scheduler profile;
    na_ok itself stays unmasked (spread eligibility reads the pod spec)."""
    na_ok = node_affinity_mask(ns, pod)
    fails = torch.stack(static_fails(ns, pod, na_ok), dim=1)   # [N,4]
    if filter_on is not None:
        fails = fails & filter_on[None, :4]
    static_scores = {
        "node_affinity": score_node_affinity(ns, pod),
        "taint_toleration": score_taint_toleration(ns, pod),
        "prefer_avoid_pods": score_prefer_avoid(ns, pod),
        "simon": score_simon(ns, pod),
    }
    return ~fails.any(dim=1), first_failure(fails), static_scores, na_ok


@sanitizable("ops.grouped:_group_jit")
def schedule_group(
    ns: NodeStatic,
    carry: Carry,
    pod: PodRow,
    group_size: int,
    valid_count: int,
    weights: torch.Tensor,
    filter_on=None,
    extra_filters=(),
    extra_scores=(),
):
    """Schedule `group_size` copies of one pod spec; only the first
    `valid_count` steps may commit. Returns (carry, (nodes i32[G], reasons
    i32[G,F], gpu_take i32[G,GD], vg_take f32[G,V], dev_take f32[G,DV])).

    One step per pod, a Python loop with no host sync inside it. A step
    past `valid_count` commits nothing, so the state is frozen there and
    every such step gives the same row: it is evaluated once and repeated."""
    static_ok, static_ff, static_scores, na_ok = _static_parts(ns, pod, weights, filter_on)
    fo = torch.ones(NUM_FILTERS, dtype=torch.bool, device=ns.valid.device) if filter_on is None else filter_on
    keys = pod_keys(ns, pod)
    spread_sel, aff_sel = pod.spread_sel.long(), pod.aff_sel.long()
    N = ns.valid.shape[0]
    nodes_idx = nx.node_ids(N, ns.valid.device)

    def step(c: Carry, active: bool):
        port_ok = ports_mask(c, pod) | ~fo[F_NODE_PORTS]
        res_fail = resource_fail(ns, c, pod) & fo[F_RESOURCES]
        spread_ok = _spread_rows_ok(ns, keys.spread, c.sel_counts[spread_sel], pod, na_ok) | ~fo[F_SPREAD]
        aff_ok = (
            _affinity_rows_ok(ns, keys.aff, c.sel_counts[aff_sel], pod)
            & _anti_sym_ok(ns, keys.anti, c.anti_counts, pod)
        ) | ~fo[F_POD_AFFINITY]
        storage_ok, vg_take_all, dev_take_all, storage_raw = local_storage_eval(ns, c, pod)
        gpu_ok = gpu_mask(ns, c, pod)
        extra_ok = torch.ones_like(ns.valid)
        for f in extra_filters:
            extra_ok = extra_ok & plugin_call(f, ns, c, pod)
        mask = (
            static_ok & port_ok & ~res_fail & spread_ok & aff_ok & storage_ok
            & gpu_ok & extra_ok & ns.valid
        )
        la, ba = _la_ba(ns, pod, c.free[:, :2])
        by_name = {
            "balanced_allocation": ba,
            "least_allocated": la,
            "topology_spread": _spread_score(ns, keys.spread, c.sel_counts[spread_sel], pod, na_ok),
            "inter_pod_affinity": _affinity_score(ns, keys.aff, c.sel_counts[aff_sel], pod),
            "gpu_share": score_gpu_share(ns, c, pod),
            "open_local": torch.where(pod.has_local, _minmax_normalize(storage_raw, ns.valid), 0.0),
            **static_scores,
        }
        score = combine_scores(by_name, weights)
        for fn, w in extra_scores:
            score = score + w * plugin_call(fn, ns, c, pod)
        score = torch.where(mask, score, float("-inf"))
        node = nx.node_argmax(score)
        ok = nx.node_any(mask) & active
        onehot = (nodes_idx == node) & ok
        sel = onehot.to(torch.float32)
        gpu_take, gpu_free = gpu_allocate(ns, c, pod, onehot)
        vg_free, dev_free, vg_take, dev_take = _storage_commit(c, sel, vg_take_all, dev_take_all)
        port_any, port_wild, port_ipc = ports_commit(c, pod, onehot)

        # the first failing filter, in filter order after the static four
        first_fail = torch.full_like(static_ff, NUM_FILTERS)
        for bad, f in (
            (~extra_ok, F_EXTRA), (~gpu_ok, F_GPU), (~storage_ok, F_STORAGE),
            (~aff_ok, F_POD_AFFINITY), (~spread_ok, F_SPREAD), (res_fail, F_RESOURCES),
            (~port_ok, F_NODE_PORTS),
        ):
            first_fail = torch.where(bad, f, first_fail)
        first_fail = torch.where(static_ff < NUM_FILTERS, static_ff, first_fail)
        reasons = torch.where(ok, 0, reason_row(first_fail, ns.valid))
        new_c = Carry(
            free=c.free - sel[:, None] * pod.req[None, :],
            sel_counts=c.sel_counts + pod.match_sel.to(torch.float32)[:, None] * sel[None, :],
            gpu_free=gpu_free, vg_free=vg_free, dev_free=dev_free,
            port_any=port_any, port_wild=port_wild, port_ipc=port_ipc,
            anti_counts=c.anti_counts + pod.own_anti[:, None] * sel[None, :],
        )
        return new_c, (
            torch.where(ok, node, -1).to(torch.int32), reasons,
            gpu_take.to(torch.int32), vg_take, dev_take,
        )

    outs = []
    for _ in range(min(valid_count, group_size)):
        carry, out = scanmark.step("ops.grouped:step", 0, step, carry, True)
        outs.append(out)
    if group_size > valid_count:
        outs += [scanmark.step("ops.grouped:step", 0, step, carry, False)[1]] * (
            group_size - max(valid_count, 0))
    return carry, tuple(torch.stack(col) for col in zip(*outs))


def schedule_batch_grouped(
    ns: NodeStatic,
    carry: Carry,
    batch: PodBatch,
    weights,
    max_group_chunk: int = DEFAULT_GROUP_CHUNK,
    filter_on=None,
    extra_filters=(),
    extra_scores=(),
    device=DEFAULT_DEVICE,
) -> Tuple[Carry, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """schedule_batch semantics via per-group scans, `max_group_chunk` pods
    per call. Returns (carry, nodes i32[P], reasons i32[P,F], gpu_take
    i32[P,G], vg_take f32[P,V], dev_take f32[P,DV]) with host arrays,
    identical to the oracle's."""
    dev = resolve_device(device)
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    if filter_on is not None:
        filter_on = torch.as_tensor(filter_on, dtype=torch.bool).to(dev)
    out = _empty_outputs(ns, batch.p)
    rows_all = pod_rows_from_batch(batch, dev)
    for start, length in group_runs(batch):
        row = PodRow(*(a[start] for a in rows_all))
        carry = _grouped_run(
            ns, carry, row, start, length, weights, max_group_chunk, filter_on,
            extra_filters, extra_scores, out,
        )
    return (carry,) + out


def _empty_outputs(ns: NodeStatic, p: int):
    """Host output arrays of a batch of p pods: (nodes, reasons, gpu_take,
    vg_take, dev_take), unplaced."""
    return (
        np.full(p, -1, np.int32),
        np.zeros((p, NUM_FILTERS), np.int32),
        np.zeros((p, ns.gpu_total.shape[1]), np.int32),
        np.zeros((p, ns.vg_cap.shape[1]), np.float32),
        np.zeros((p, ns.dev_cap.shape[1]), np.float32),
    )


def _grouped_run(
    ns, carry, row, start, length, weights, max_group_chunk, filter_on,
    extra_filters, extra_scores, out,
) -> Carry:
    """One group through schedule_group, chunk by chunk; each chunk's
    results come to the host in one fetch and land in `out` rows."""
    done = 0
    while done < length:
        n = min(length - done, max_group_chunk)
        # eager runs exactly n steps: the reference pads to _bucket(n) and
        # gates the steps past n off, so the first n outputs are the same
        carry, chunk = schedule_group(
            ns, carry, row, n, n, weights, filter_on, extra_filters, extra_scores  # osim: lint-ok[unbucketed-jit-shape]
        )
        for dst, got in zip(out, fetch(*chunk)):
            dst[start + done:start + done + n] = got
        done += n
    return carry


def fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Bring device tensors to the host in ONE transfer: each is viewed as
    32-bit words (bools widened to int32 first), the words are joined, and
    the host copy is split back into arrays of the original dtypes."""
    words, metas = [], []
    for t in tensors:
        metas.append((t.dtype, tuple(t.shape)))
        t = t.to(torch.int32) if t.dtype == torch.bool else t
        if t.element_size() != 4:
            raise ValueError(f"fetch: {t.dtype} is not a 32-bit type")
        words.append(t.reshape(-1).view(torch.int32))
    host = torch.cat(words).cpu().numpy() if words else np.zeros(0, np.int32)
    out, at = [], 0
    for dtype, shape in metas:
        size = math.prod(shape)
        part = host[at:at + size].reshape(shape)
        at += size
        if dtype == torch.bool:
            out.append(part != 0)
        elif dtype == torch.float32:
            out.append(part.view(np.float32))
        else:
            out.append(part)
    return out


def _row_signature(batch: PodBatch) -> np.ndarray:
    """Byte-hash every pod row's feature arrays to detect identical specs.
    Uses the compiled 128-bit row hasher (native/osim_native.cpp) when
    available; blake2b otherwise."""
    parts = []
    for f in fields(batch):
        if f.name in ("keys", "valid"):
            continue
        arr = getattr(batch, f.name)
        parts.append(np.ascontiguousarray(arr).reshape(batch.p, -1).view(np.uint8))
    blob = np.concatenate(parts, axis=1)

    hashed = native.hash_rows(blob)
    if hashed is not None:
        # host-side reinterpretation of a 128-bit digest; never enters a
        # kernel, and the view width must match the digest exactly
        return hashed.view([("a", np.uint64), ("b", np.uint64)]).reshape(-1)  # osim: lint-ok[f64-literal]
    return np.array(
        [hashlib.blake2b(row.tobytes(), digest_size=8).digest() for row in blob]
    )


def group_runs(batch: PodBatch) -> List[Tuple[int, int]]:
    """(start, length) runs of consecutive identical valid rows."""
    total = int(batch.valid.sum())
    if total == 0:
        return []
    sig = _row_signature(batch)
    # Vectorized boundary detection: per-element comparison of structured
    # rows re-promotes the dtype for every row. Iterate the signature's
    # fields generically so a digest-width or dtype change in the native
    # hasher can't silently break this.
    if sig.dtype.fields:
        diff = np.zeros(max(total - 1, 0), bool)
        for fname in sig.dtype.fields:
            col = sig[fname][:total]
            diff |= col[1:] != col[:-1]
    else:
        diff = sig[1:total] != sig[: total - 1]
    change = np.nonzero(diff)[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [total]))
    return [(int(s), int(e - s)) for s, e in zip(starts, ends)]


def _bucket(n: int) -> int:
    """Chunk-length bucket, floor 32."""
    return round_up(n, 32)
