"""Trajectory-accelerated grouped scheduling: the batched fast path.

The port of the JAX package's ops/fast.py. While a group of IDENTICAL pods
schedules, a node's local state changes only when that node is chosen, so
for one group:

  1. `build_trajectory` virtually commits the pod to EVERY node J times,
     recording per-step node-local masks, raw scores and allocation takes
     ([N,J,...] tables).
  2. Selection then needs only each node's commit count x:
     - the SORT path (`sort_select`): purely node-local scores make the
       sequential argmax a k-way merge, i.e. one stable sort of all [N,J]
       lanes;
     - the DOMAIN-MERGE path (`domain_select`): with every carry-coupled
       term keyed by non-hostname topology keys, nodes fall into a few
       combined domain classes; one stable sort keyed (class, score) orders
       every class's lanes, and a sequential pop loop over the class heads
       picks the winner of each step (`ops.domain_pop`, a CUDA kernel on
       the card, for spread-only groups; `_affinity_pop` in PyTorch for
       groups with inter-pod (anti-)affinity terms);
     - the LIGHT SCANS (`light_scan`): one step per pod over the carry x,
       the node-local state read from the trajectory and every coupled
       count rebuilt as base + match * x; the MICRO body when topology
       spread is the only coupled term. They take the groups neither path
       takes and replay the sort/domain results voided by a rising score
       sequence (`mono` False).
  3. The group tail (`gather_takes`, `cur_at` -> `light_reasons`,
     `exit_carry`) folds the commits back into the carry.

Groups too small to amortize a trajectory take the per-pod grouped scan
(`ops.grouped.schedule_group`). Placements, failure reasons, allocation
takes, the exit carry and the route each group takes are bit-identical to
the JAX package's `schedule_batch_fast`.

Exactness traps handled here (besides those of ops/kernels.py):
  - `torch.sort(..., stable=True)` reproduces jnp.argsort / lax.sort's
    stable order; the domain path's two-key sort is a stable sort by score
    followed by a stable sort by class;
  - `_sel_j` gathers one lane per node instead of the reference's one-hot
    sum, adding +0.0 so a -0.0 lane reads back as +0.0 like the sum does;
  - feasibility and partial scores are selected separately, so no
    `-inf * 0` NaN appears;
  - scatter-adds are `index_add_` on int32;
  - the scan loops keep every per-step value (node, ok, lane) on the device:
    indices are 1-element tensors used through gather / index_select /
    index_copy_, never Python ints.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..utils import metrics as _metrics
from . import delta as _delta
from . import domain_pop as _dp
from . import wave as _wave
from .domain_pop import _hard_spread_ok, _spread_norm
from .encode import PodBatch, round_up
from .grouped import (
    DEFAULT_GROUP_CHUNK,
    _bucket,
    _empty_outputs,
    _grouped_run,
    _static_parts,
    fetch,
    group_runs,
)
from .kernels import (
    Carry,
    F_GPU,
    F_NODE_PORTS,
    F_POD_AFFINITY,
    F_RESOURCES,
    F_SPREAD,
    F_STORAGE,
    NUM_FILTERS,
    NodeStatic,
    PodRow,
    WEIGHT_ORDER,
    _EPS,
    _affinity_rows_ok,
    _affinity_score,
    _anti_sym_ok,
    _la_ba,
    _minmax_normalize,
    _spread_rows_ok,
    _spread_score,
    combine_scores,
    commit_choices_lanes,
    commit_parts,
    gpu_allocate_rowwise,
    gpu_mask,
    gpu_share_raw,
    local_storage_eval,
    pod_keys,
    port_adds,
    ports_mask,
    reason_row,
    resource_fail,
    schedule_step,
)
from .state import pod_rows_from_batch

_log = logging.getLogger("osim")

# Trajectories longer than this take the per-pod grouped path.
J_CAP = 512

# Max combined (domain-tuple, eligibility) classes for the domain-merge path;
# more fragmented groups take the light scans. Tests may set this to 0 to
# force the micro body.
DM_CAP = 64

# Groups scheduled per strategy since import: the reference's keys, plus
# "domain_kernel", the launches of the domain_pop CUDA kernel. The port has
# no Pallas route, so "domain_pallas" stays 0 as in the reference's default.
PATH_COUNTS = {
    "sort": 0, "micro": 0, "scan": 0, "grouped": 0, "sort_fallback": 0,
    "domain": 0, "domain_fallback": 0, "domain_pallas": 0, "domain_kernel": 0,
}
_PATH_LOCK = threading.Lock()  # simulate() may run on two threads at once (the server)


def _count_path(route: str, n: int = 1) -> None:
    with _PATH_LOCK:
        PATH_COUNTS[route] += n

# Channel layout of Trajectory.packed.
CH_CPU, CH_MEM, CH_RES_FAIL, CH_PORT_OK, CH_STO_OK, CH_GPU_OK = range(6)
CH_STO_RAW, CH_GPU_RAW = 6, 7
N_CH = 8

SP_IDX = WEIGHT_ORDER.index("topology_spread")
IPA_IDX = WEIGHT_ORDER.index("inter_pod_affinity")
assert SP_IDX == len(WEIGHT_ORDER) - 1 and IPA_IDX == SP_IDX - 1, (
    "the partial-sum splits need the carry-coupled terms LAST in the fold"
)

_NEG_INF = float("-inf")


class Trajectory(NamedTuple):
    """Per-node state/score evolution for one pod spec: index j = value after
    j commits of this pod onto that node. Tables of state that cannot change
    for the group (no GPU / storage request) are broadcast views."""
    free: torch.Tensor         # f32[N,J,R]
    gpu_free: torch.Tensor     # f32[N,J,G]
    vg_free: torch.Tensor      # f32[N,J,V]
    dev_free: torch.Tensor     # f32[N,J,DV]
    gpu_take: torch.Tensor     # f32[N,J,G]
    vg_take: torch.Tensor      # f32[N,J,V]
    dev_take: torch.Tensor     # f32[N,J,DV]
    packed: torch.Tensor       # f32[N,J,N_CH]


class GroupFlags(NamedTuple):
    """Host-known facts about a group's pod spec. Every prune they allow
    replaces a subcomputation with the constant the full computation gives
    for this spec, so results stay bit-identical."""
    dyn_ports: bool      # pod requests host ports (port state evolves)
    dyn_storage: bool    # pod has open-local volumes
    dyn_gpu: bool        # pod requests GPU share (gpu_free evolves)
    any_hard_spread: bool
    any_soft_spread: bool
    any_req_aff: bool    # required (anti)affinity terms
    any_pref_aff: bool   # preferred (anti)affinity terms
    any_anti_sym: bool   # existing anti-affinity terms repel this pod
    # topology spread over non-hostname keys is the ONLY carry-coupled term
    # and there are no GPU/storage dynamics: the micro light-scan body
    micro_spread: bool = False
    # every carry-coupled term is domain-keyed over non-hostname keys and
    # there are no GPU/storage dynamics: the domain-merge path applies
    domain_aff: bool = False


ALL_DYNAMIC = GroupFlags(*([True] * 8))


def group_flags(row_np: dict, anti_topo_np: np.ndarray) -> GroupFlags:
    """Derive GroupFlags from one pod's numpy feature row."""
    spread_active = row_np["spread_topo"] >= 0
    soft = spread_active & ~row_np["spread_hard"]
    aff_active = row_np["aff_topo"] >= 0
    anti_match = (anti_topo_np >= 0) & row_np["match_anti"]
    f = GroupFlags(
        dyn_ports=bool((row_np["hp_pid"] > 0).any()),
        dyn_storage=bool(row_np["has_local"]),
        dyn_gpu=bool(row_np["gpu_mem"] > 0),
        any_hard_spread=bool((spread_active & row_np["spread_hard"]).any()),
        any_soft_spread=bool(soft.any()),
        any_req_aff=bool((aff_active & row_np["aff_required"]).any()),
        any_pref_aff=bool((aff_active & ~row_np["aff_required"]).any()),
        any_anti_sym=bool(anti_match.any()),
    )
    # hostname-keyed constraints count per node, not per domain
    keys_domainable = (
        bool((row_np["spread_topo"][spread_active] > 0).all())
        and bool((row_np["aff_topo"][aff_active] > 0).all())
        and bool((anti_topo_np[anti_match] > 0).all())
    )
    no_dyn = not f.dyn_gpu and not f.dyn_storage and keys_domainable
    any_spread = f.any_soft_spread or f.any_hard_spread
    return f._replace(
        micro_spread=any_spread and not _any_affinity(f) and no_dyn,
        domain_aff=(any_spread or _any_affinity(f)) and no_dyn,
    )


def _any_affinity(flags: GroupFlags) -> bool:
    return flags.any_req_aff or flags.any_pref_aff or flags.any_anti_sym


def build_trajectory(
    ns: NodeStatic,
    carry: Carry,
    pod: PodRow,
    weights: torch.Tensor,
    j_steps: int,
    filter_on=None,
    flags: GroupFlags = ALL_DYNAMIC,
):
    """Virtual-commit the pod to every node j_steps times, recording the
    node-local evolution, plus the group's static masks/scores.

    Returns (Trajectory, static_ok, static_ff, static_scores, na_ok).

    The J-step scan is a Python loop. State the pod cannot change (host
    ports, storage, GPU memory when `flags` says it requests none) stays
    equal to its entry value at every step — the reference's updates add or
    subtract exact zeros — so its masks, scores and takes are evaluated once
    and broadcast over the J lanes."""
    N, R = carry.free.shape
    J = j_steps
    dev = carry.free.device

    def lanes(shape, dtype=torch.float32):
        return torch.empty((N, J) + tuple(shape), dtype=dtype, device=dev)

    def bcast(v):
        return v[:, None].expand((N, J) + tuple(v.shape[1:]))

    free = lanes((R,))
    res_fail = lanes((), torch.bool)
    if flags.dyn_ports:
        add_any, add_wild, add_ipc = port_adds(
            carry.port_any.shape[0], carry.port_ipc.shape[0], pod
        )
        port_ok = lanes((), torch.bool)
    else:
        port_ok = bcast(ports_mask(carry, pod))
    if flags.dyn_storage:
        vg_free, dev_free = lanes(carry.vg_free.shape[1:]), lanes(carry.dev_free.shape[1:])
        vg_take, dev_take = lanes(carry.vg_free.shape[1:]), lanes(carry.dev_free.shape[1:])
        sto_ok, sto_raw = lanes((), torch.bool), lanes(())
    else:
        ok, vg_t, dev_t, raw = local_storage_eval(ns, carry, pod)
        vg_free, dev_free = bcast(carry.vg_free), bcast(carry.dev_free)
        vg_take, dev_take, sto_ok, sto_raw = bcast(vg_t), bcast(dev_t), bcast(ok), bcast(raw)
    if flags.dyn_gpu:
        gpu_free, gpu_take = lanes(carry.gpu_free.shape[1:]), lanes(carry.gpu_free.shape[1:])
        g_ok, g_raw = lanes((), torch.bool), lanes(())
    else:
        gpu_free = bcast(carry.gpu_free)
        gpu_take = bcast(gpu_allocate_rowwise(ns, carry.gpu_free, pod))
        g_ok, g_raw = bcast(gpu_mask(ns, carry, pod)), bcast(gpu_share_raw(ns, carry, pod))

    vc = carry
    for j in range(J):
        free[:, j] = vc.free
        res_fail[:, j] = resource_fail(ns, vc, pod)
        upd = {"free": vc.free - pod.req[None, :]}
        if flags.dyn_ports:
            port_ok[:, j] = ports_mask(vc, pod)
            upd.update(
                port_any=vc.port_any + add_any[:, None],
                port_wild=vc.port_wild + add_wild[:, None],
                port_ipc=vc.port_ipc + add_ipc[:, None],
            )
        if flags.dyn_storage:
            ok, vg_t, dev_t, raw = local_storage_eval(ns, vc, pod)
            vg_free[:, j], dev_free[:, j] = vc.vg_free, vc.dev_free
            vg_take[:, j], dev_take[:, j], sto_ok[:, j], sto_raw[:, j] = vg_t, dev_t, ok, raw
            upd.update(vg_free=vc.vg_free - vg_t, dev_free=vc.dev_free - dev_t)
        if flags.dyn_gpu:
            g_t = gpu_allocate_rowwise(ns, vc.gpu_free, pod)
            gpu_free[:, j], gpu_take[:, j] = vc.gpu_free, g_t
            g_ok[:, j], g_raw[:, j] = gpu_mask(ns, vc, pod), gpu_share_raw(ns, vc, pod)
            upd.update(gpu_free=vc.gpu_free - g_t * pod.gpu_mem)
        vc = vc._replace(**upd)

    f32 = torch.float32
    packed = torch.stack(
        [
            free[:, :, 0], free[:, :, 1], res_fail.to(f32), port_ok.to(f32),
            sto_ok.to(f32), g_ok.to(f32), sto_raw, g_raw,
        ],
        dim=2,
    )
    traj = Trajectory(free, gpu_free, vg_free, dev_free, gpu_take, vg_take, dev_take, packed)
    static_ok, static_ff, static_scores, na_ok = _static_parts(ns, pod, weights, filter_on)
    return traj, static_ok, static_ff, static_scores, na_ok


def _sel_j(traj_arr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """traj_arr[n, x_n] for every node (0 / False where x_n is out of
    range). The +0.0 turns a -0.0 lane into +0.0, as the reference's one-hot
    sum does."""
    N, J = traj_arr.shape[:2]
    v = traj_arr[torch.arange(N, device=x.device), x.clamp(0, J - 1).long()]
    inb = ((x >= 0) & (x < J)).reshape((N,) + (1,) * (v.dim() - 1))
    if v.dtype == torch.bool:
        return v & inb
    return torch.where(inb, v, 0.0) + 0.0


def _lane_rows(ns: NodeStatic, traj: Trajectory, pod: PodRow, static_scores: dict) -> dict:
    """The node-local score rows per (node, lane), shared by the sort path,
    the micro body and the domain path. Assumes gpu_free is frozen for the
    group and no storage volumes / preferred affinity terms."""
    N, J, _ = traj.packed.shape
    la, ba = _la_ba(ns, pod, traj.packed[:, :, CH_CPU:CH_MEM + 1])
    gpu_score = _minmax_normalize(traj.packed[:, 0, CH_GPU_RAW], ns.valid)

    def bcast(v):
        return v[:, None].expand(N, J)

    zeros = torch.zeros((N, J), dtype=torch.float32, device=la.device)
    return {
        "balanced_allocation": ba,
        "least_allocated": la,
        "inter_pod_affinity": zeros,
        "gpu_share": bcast(gpu_score),
        "open_local": zeros,
        **{k: bcast(v) for k, v in static_scores.items()},
    }


def _light_eval(
    ns: NodeStatic,
    carry0: Carry,
    pod: PodRow,
    static_ok: torch.Tensor,
    static_scores: dict,
    na_ok: torch.Tensor,
    weights: torch.Tensor,
    fo: torch.Tensor,
    x: torch.Tensor,
    cur: torch.Tensor,
    flags: GroupFlags,
    hoisted: dict,
):
    """Feasibility + scores at commit state (x, cur = packed[n, x_n]).
    Returns (score f32[N] with -inf on infeasible, dict of effective
    per-filter bools for first-fail attribution). Every coupled count is
    rebuilt exactly as base + match * x and fed through the per-step
    kernels' own row helpers."""
    N = ns.valid.shape[0]
    ones = torch.ones(N, dtype=torch.bool, device=x.device)
    zeros = torch.zeros(N, dtype=torch.float32, device=x.device)
    xf = x.to(torch.float32)
    keys = hoisted["keys"]
    free2 = cur[:, CH_CPU:CH_MEM + 1]
    res_fail_x = (cur[:, CH_RES_FAIL] > 0.5) & fo[F_RESOURCES]
    port_ok = ((cur[:, CH_PORT_OK] > 0.5) | ~fo[F_NODE_PORTS]) if flags.dyn_ports else ones
    storage_ok = (cur[:, CH_STO_OK] > 0.5) if flags.dyn_storage else ones
    gpu_ok = (cur[:, CH_GPU_OK] > 0.5) if flags.dyn_gpu else ones

    def rows(sel):
        """The rows' selector counts after x commits of this pod."""
        sel = sel.long()
        return carry0.sel_counts[sel] + pod.match_sel[sel].to(torch.float32)[:, None] * xf[None, :]

    if flags.any_hard_spread or flags.any_soft_spread:
        spread_rows = rows(pod.spread_sel)
    spread_ok = ones
    if flags.any_hard_spread:
        spread_ok = _spread_rows_ok(ns, keys.spread, spread_rows, pod, na_ok) | ~fo[F_SPREAD]
    if flags.any_req_aff or flags.any_pref_aff:
        aff_rows = rows(pod.aff_sel)
    req_ok = _affinity_rows_ok(ns, keys.aff, aff_rows, pod) if flags.any_req_aff else ones
    sym_ok = ones
    if flags.any_anti_sym:
        anti_rows = carry0.anti_counts + pod.own_anti[:, None] * xf[None, :]
        sym_ok = _anti_sym_ok(ns, keys.anti, anti_rows, pod)
    aff_ok = (req_ok & sym_ok) | ~fo[F_POD_AFFINITY]

    mask = (
        static_ok & port_ok & ~res_fail_x & spread_ok & aff_ok & storage_ok
        & gpu_ok & ns.valid
    )
    la, ba = _la_ba(ns, pod, free2)
    by_name = {
        "balanced_allocation": ba,
        "least_allocated": la,
        "topology_spread": (
            _spread_score(ns, keys.spread, spread_rows, pod, na_ok)
            if flags.any_soft_spread else torch.full((N,), 100.0, device=x.device)
        ),
        "inter_pod_affinity": (
            _affinity_score(ns, keys.aff, aff_rows, pod) if flags.any_pref_aff else zeros
        ),
        "gpu_share": (
            _minmax_normalize(cur[:, CH_GPU_RAW], ns.valid)
            if flags.dyn_gpu else hoisted["gpu_score"]
        ),
        "open_local": (
            torch.where(pod.has_local, _minmax_normalize(cur[:, CH_STO_RAW], ns.valid), 0.0)
            if flags.dyn_storage else zeros
        ),
        **static_scores,
    }
    score = torch.where(mask, combine_scores(by_name, weights), _NEG_INF)
    parts = {
        "port_ok": port_ok, "res_fail": res_fail_x, "spread_ok": spread_ok,
        "aff_ok": aff_ok, "storage_ok": storage_ok, "gpu_ok": gpu_ok,
    }
    return score, parts


def _hoisted_values(ns: NodeStatic, pod: PodRow, cur: torch.Tensor, flags: GroupFlags) -> dict:
    """Group-invariant values _light_eval needs: the pod's topology row
    tables and, for a non-GPU group, the gpu-share score frozen at its entry
    value."""
    out = {"keys": pod_keys(ns, pod)}
    if not flags.dyn_gpu:
        out["gpu_score"] = _minmax_normalize(cur[:, CH_GPU_RAW], ns.valid)
    return out


def _sortable(flags: GroupFlags) -> bool:
    """Sort-path eligible: every score/mask is a function of the node's OWN
    commit count alone (no spread/affinity coupling, no GPU/storage)."""
    return not (
        flags.any_hard_spread or flags.any_soft_spread or _any_affinity(flags)
        or flags.dyn_gpu or flags.dyn_storage
    )


def _filters_on(filter_on, dev) -> torch.Tensor:
    if filter_on is None:
        return torch.ones(NUM_FILTERS, dtype=torch.bool, device=dev)
    return filter_on


def sort_select(
    ns: NodeStatic,
    traj: Trajectory,
    pod: PodRow,
    static_ok: torch.Tensor,
    static_scores: dict,
    weights: torch.Tensor,
    valid_count: int,
    out_size: int,
    filter_on=None,
):
    """Whole-group selection in ONE stable sort for sort-eligible groups.

    Returns (mono_ok, nodes i32[out_size], jidx i32[out_size], x i32[N]);
    mono_ok False (some node's score sequence rises) voids the result."""
    N, J, _ = traj.packed.shape
    dev = traj.packed.device
    fo = _filters_on(filter_on, dev)
    packed = traj.packed
    res_fail = packed[:, :, CH_RES_FAIL] > 0.5
    port_ok = (packed[:, :, CH_PORT_OK] > 0.5) | ~fo[F_NODE_PORTS]
    storage_ok = packed[:, :, CH_STO_OK] > 0.5
    gpu_ok = packed[:, :, CH_GPU_OK] > 0.5
    mask = (
        static_ok[:, None] & port_ok & ~res_fail & storage_ok & gpu_ok
        & ns.valid[:, None]
    )
    by_name = dict(_lane_rows(ns, traj, pod, static_scores))
    by_name["topology_spread"] = torch.full((N, J), 100.0, device=dev)
    score = torch.where(mask, combine_scores(by_name, weights), _NEG_INF)
    mono_ok = (score[:, 1:] <= score[:, :-1]).all()

    flat = score.reshape(-1)
    order = torch.sort(-flat, stable=True).indices[:out_size]
    sel_score = flat[order]
    feasible = torch.isfinite(sel_score) & (
        torch.arange(out_size, device=dev) < valid_count
    )
    sel_n = (order // J).to(torch.int32)
    sel_j = (order % J).to(torch.int32)
    nodes = torch.where(feasible, sel_n, -1)
    jidx = torch.where(feasible, sel_j, 0)
    x = torch.zeros(N, dtype=torch.int32, device=dev).index_add_(
        0, sel_n.long(), feasible.to(torch.int32)
    )
    return mono_ok, nodes, jidx, x


def cur_at(traj: Trajectory, x: torch.Tensor) -> torch.Tensor:
    """packed[n, x_n] for every node."""
    return _sel_j(traj.packed, x)


def _active_steps(offset: int, group_size: int, valid_count: int) -> int:
    """Steps of a scan call that may commit: those with offset + i <
    valid_count, a prefix of the call's group_size steps. The rest commit
    nothing and output node -1, lane 0."""
    return max(0, min(group_size, valid_count - offset))


def _step_outputs(vals: list, size: int, pad: int, dev) -> torch.Tensor:
    """Per-step 1-element outputs joined into i32[size], padded for the
    steps that did not run."""
    out = torch.full((size,), pad, dtype=torch.int32, device=dev)
    if vals:
        out[: len(vals)] = torch.cat(vals).to(torch.int32)
    return out


def light_scan(
    ns: NodeStatic,
    traj: Trajectory,
    carry0: Carry,
    pod: PodRow,
    static_ok: torch.Tensor,
    static_scores: dict,
    na_ok: torch.Tensor,
    weights: torch.Tensor,
    x0: torch.Tensor,
    offset: int,
    group_size: int,
    valid_count: int,
    filter_on=None,
    flags: GroupFlags = ALL_DYNAMIC,
):
    """Select nodes for `group_size` pods of the group, starting from commit
    state x0 (chunks of one group thread x through). Only steps with
    offset + i < valid_count commit. Returns (x, nodes i32[G], jidx i32[G]).

    One step per pod, a Python loop on the device with no host sync. The
    loop keeps `cur` = packed[n, x_n] for every node, refreshing only the
    chosen node's row per step. Failure reasons are not computed per step:
    an infeasible step commits nothing, so every later step of the group
    fails identically and light_reasons attributes the suffix once.
    `flags.micro_spread` selects the micro body (_light_scan_micro)."""
    fo = _filters_on(filter_on, x0.device)
    if flags.micro_spread:
        return _light_scan_micro(
            ns, traj, carry0, pod, static_ok, static_scores, na_ok, weights,
            x0, offset, group_size, valid_count, fo, flags,
        )
    N, J, _ = traj.packed.shape
    packed_flat = traj.packed.reshape(N * J, N_CH)
    x = x0.clone()
    cur = cur_at(traj, x0)
    hoisted = _hoisted_values(ns, pod, cur, flags)
    nodes, jidxs = [], []
    for _ in range(_active_steps(offset, group_size, valid_count)):
        score, _ = _light_eval(
            ns, carry0, pod, static_ok, static_scores, na_ok, weights, fo,
            x, cur, flags, hoisted,
        )
        node = score.argmax().view(1)
        # any(mask) == the winning score is finite (infeasible rows are -inf)
        ok = score.gather(0, node) > _NEG_INF
        x_node = x.gather(0, node)
        nodes.append(torch.where(ok, node, -1))
        jidxs.append(torch.where(ok, x_node, 0))
        x.index_add_(0, node, ok.to(torch.int32))
        j_next = (x_node + 1).clamp(0, J - 1)
        new_row = packed_flat.index_select(0, node * J + j_next)
        cur.index_copy_(0, node, torch.where(ok[:, None], new_row, cur.index_select(0, node)))
    dev = x0.device
    return x, _step_outputs(nodes, group_size, -1, dev), _step_outputs(jidxs, group_size, 0, dev)


class SpreadTables(NamedTuple):
    """Loop-invariant spread-reconstruction tables shared by the micro body
    and the domain path."""
    k_c: torch.Tensor       # i64[C] topo key per constraint row
    to_c: torch.Tensor      # f32[C,D,N] domain membership per constraint
    elig_f: torch.Tensor    # f32[N] spread eligibility (na_ok & valid)
    match_c: torch.Tensor   # f32[C] pod matches the constraint's selector
    base_dom: torch.Tensor  # f32[C,D] eligible-node counts at group entry
    active_c: torch.Tensor  # bool[C] soft rows (feed the score)
    hard_c: torch.Tensor    # bool[C] DoNotSchedule rows (feed the mask)
    in_key_cd: Optional[torch.Tensor]  # bool[C,D] eligible domains of the row's key


def _spread_tables(
    ns: NodeStatic, carry0: Carry, pod: PodRow, na_ok, flags: GroupFlags
) -> SpreadTables:
    """Spread tables (non-hostname keys); the count sums are exact integer
    reductions (the reference's Precision.HIGHEST einsums)."""
    active_c = (pod.spread_topo >= 0) & ~pod.spread_hard
    hard_c = (pod.spread_topo >= 0) & pod.spread_hard
    k_c = pod.spread_topo.clamp(min=0).long()
    to_c = ns.topo_onehot[k_c]                                    # [C,D,N]
    elig_f = (na_ok & ns.valid).to(torch.float32)
    sel = pod.spread_sel.long()
    base_rows = carry0.sel_counts[sel]                            # [C,N]
    match_c = pod.match_sel[sel].to(torch.float32)
    counts0 = torch.where(elig_f > 0, base_rows, 0.0)
    base_dom = (to_c * counts0[:, None, :]).sum(dim=2)            # [C,D]
    in_key_cd = None
    if flags.any_hard_spread:
        dom_elig = (to_c * elig_f).sum(dim=2) > 0.0
        in_key_cd = (ns.domain_key[None, :] == k_c[:, None]) & dom_elig
    return SpreadTables(k_c, to_c, elig_f, match_c, base_dom, active_c, hard_c, in_key_cd)


def _lane_partials(
    ns, traj, pod, static_scores, static_ok, weights, fo, prefix_end=SP_IDX
):
    """(partial, feas) per lane: the left-fold prefix of combine_scores
    through WEIGHT_ORDER[:prefix_end], and the lane feasibility (ports and
    resources, the only dynamics a micro/domain-eligible group has)."""
    p9 = combine_scores(
        _lane_rows(ns, traj, pod, static_scores), weights,
        order=WEIGHT_ORDER[:prefix_end],
    )
    packed = traj.packed
    feas = (
        static_ok[:, None]
        & ((packed[:, :, CH_PORT_OK] > 0.5) | ~fo[F_NODE_PORTS])
        & ~((packed[:, :, CH_RES_FAIL] > 0.5) & fo[F_RESOURCES])
        & ns.valid[:, None]
    )
    return p9, feas


def _light_scan_micro(
    ns, traj, carry0, pod, static_ok, static_scores, na_ok, weights,
    x0, offset, group_size, valid_count, fo, flags,
):
    """The topology-spread micro body: the 9 node-local score rows are
    hoisted into a per-lane partial sum, so the step is `partial9 + w_sp *
    spread` (+ the DoNotSchedule skew mask) over domain counts kept as
    base + match * y, y the eligible commits per domain. An exact split of
    combine_scores' left fold, since topology_spread is its last term."""
    N, J, _ = traj.packed.shape
    p9, feas = _lane_partials(ns, traj, pod, static_scores, static_ok, weights, fo)
    w_sp = weights[SP_IDX]
    score_flat = torch.where(feas, p9, _NEG_INF).reshape(-1)
    st = _spread_tables(ns, carry0, pod, na_ok, flags)
    if flags.any_hard_spread:
        has_key_cn = (ns.topo[:, st.k_c] >= 0).T                  # [C,N]
    y = (st.to_c * (st.elig_f * x0.to(torch.float32))).sum(dim=2)  # [C,D]
    # p9 and feasibility are selected separately: a one-hot multiply of the
    # -inf lanes would give NaN
    cur_s = torch.where(_sel_j(feas, x0), _sel_j(p9, x0), _NEG_INF)
    x = x0.clone()
    nodes, jidxs = [], []
    for _ in range(_active_steps(offset, group_size, valid_count)):
        dom = st.base_dom + st.match_c[:, None] * y
        cnt = (dom[:, :, None] * st.to_c).sum(dim=1)              # [C,N]
        raw = torch.where(st.active_c[:, None], cnt, 0.0).sum(dim=0)
        score = cur_s + w_sp * _spread_norm(raw, ns.valid)        # -inf stays
        if flags.any_hard_spread:
            spread_ok = _hard_spread_ok(
                dom, cnt, st.in_key_cd, st.hard_c, pod.spread_skew, has_key_cn, fo[F_SPREAD],
            )
            score = torch.where(spread_ok, score, _NEG_INF)
        node = score.argmax().view(1)
        ok = score.gather(0, node) > _NEG_INF
        x_node = x.gather(0, node)
        nodes.append(torch.where(ok, node, -1))
        jidxs.append(torch.where(ok, x_node, 0))
        x.index_add_(0, node, ok.to(torch.int32))
        j_next = (x_node + 1).clamp(0, J - 1)
        new_s = score_flat.index_select(0, node * J + j_next)
        cur_s.index_copy_(0, node, torch.where(ok, new_s, cur_s.index_select(0, node)))
        to_col = st.to_c.index_select(2, node)[:, :, 0]           # [C,D]
        y = y + to_col * (st.elig_f.index_select(0, node) * ok.to(torch.float32))
    dev = x0.device
    return x, _step_outputs(nodes, group_size, -1, dev), _step_outputs(jidxs, group_size, 0, dev)


class DomainPlan(NamedTuple):
    """Host-built partition of nodes into combined (domain-tuple,
    eligibility) classes for the domain-merge path. Dc is padded to
    max(4, next_pow2(real classes)); the tail classes are empty."""
    combo_of_node: np.ndarray  # i32[N] class id per node
    counts: np.ndarray         # i32[Dc] trajectory lanes per class (nodes * J)
    offsets: np.ndarray        # i32[Dc] class start in the combo-sorted order
    elig_combo: np.ndarray     # f32[Dc] 1.0 = class counts for spread
    combo_valid: np.ndarray    # bool[Dc] class holds >= 1 valid node
    t_onehot: np.ndarray       # f32[C,D,Dc] spread-row domain membership
    has_key: np.ndarray        # bool[C,Dc] class has spread row c's topo key
    t_aff: np.ndarray          # f32[CA,D,Dc] affinity-row domain membership
    has_key_aff: np.ndarray    # bool[CA,Dc]
    t_anti: np.ndarray         # f32[AT,D,Dc] anti-sym-term domain membership
    has_key_anti: np.ndarray   # bool[AT,Dc]


def _map_onehot(keys_np, act, uniq_cols, col_of, dc, dc_pad, n_domains):
    """(map, onehot) for one constraint family: map[r, m] = class m's domain
    under row r's topo key (-1 when inactive / key missing)."""
    R = keys_np.shape[0]
    m = np.full((R, dc_pad), -1, np.int32)
    act_rows = np.nonzero(act)[0]
    if act_rows.size:
        m[act_rows[:, None], np.arange(dc)[None, :]] = uniq_cols[
            :, [col_of[int(keys_np[r])] for r in act_rows]
        ].T
    onehot = (
        m[:, None, :] == np.arange(n_domains)[None, :, None]
    ).astype(np.float32)
    return m, onehot


def _domain_plan(
    spread_topo_np: np.ndarray,
    aff_topo_np: np.ndarray,
    anti_topo_np: np.ndarray,
    match_anti_np: np.ndarray,
    topo_np: np.ndarray,
    valid_np: np.ndarray,
    elig_np: np.ndarray,
    j_steps: int,
    n_domains: int,
):
    """Partition nodes into combined domain classes over every coupled
    term's topology key plus the spread-eligibility bit; None when the group
    is too fragmented (Dc > DM_CAP)."""
    s_act = spread_topo_np >= 0
    a_act = aff_topo_np >= 0
    t_act = (anti_topo_np >= 0) & match_anti_np
    keys = np.unique(np.concatenate([
        spread_topo_np[s_act], aff_topo_np[a_act], anti_topo_np[t_act],
    ]))
    col_of = {int(k): i for i, k in enumerate(keys)}
    cols = topo_np[:, keys]
    if s_act.any():
        keymat = np.concatenate([cols, elig_np[:, None].astype(np.int32)], axis=1)
    else:
        keymat = cols
    uniq, inv = np.unique(keymat, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    dc = uniq.shape[0]
    if dc > DM_CAP:
        return None
    dc_pad = max(4, 1 << (dc - 1).bit_length())
    node_counts = np.bincount(inv, minlength=dc_pad)
    counts = (node_counts * j_steps).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    elig_combo = np.zeros(dc_pad, np.float32)
    if s_act.any():
        elig_combo[:dc] = uniq[:, -1]
        uniq_cols = uniq[:, :-1]
    else:
        uniq_cols = uniq
    combo_valid = np.zeros(dc_pad, bool)
    np.logical_or.at(combo_valid, inv, valid_np)
    map_s, t_onehot = _map_onehot(spread_topo_np, s_act, uniq_cols, col_of, dc, dc_pad, n_domains)
    map_a, t_aff = _map_onehot(aff_topo_np, a_act, uniq_cols, col_of, dc, dc_pad, n_domains)
    map_t, t_anti = _map_onehot(anti_topo_np, t_act, uniq_cols, col_of, dc, dc_pad, n_domains)
    return DomainPlan(
        inv.astype(np.int32), counts, offsets, elig_combo, combo_valid,
        t_onehot, map_s >= 0, t_aff, map_a >= 0, t_anti, map_t >= 0,
    )


def domain_select(
    ns: NodeStatic,
    traj: Trajectory,
    carry0: Carry,
    pod: PodRow,
    static_ok: torch.Tensor,
    static_scores: dict,
    na_ok: torch.Tensor,
    weights: torch.Tensor,
    plan: DomainPlan,
    group_size: int,
    l_cap: int,
    valid_count: int,
    filter_on=None,
    flags: GroupFlags = ALL_DYNAMIC,
):
    """Whole-group selection with an O(Dc) pop-loop state for domain groups
    (every coupled term keyed by non-hostname topology keys, no GPU/storage
    dynamics).

    Nodes of one combined class share every coupled count, so within a class
    the pick order is the sort-path merge: one stable sort of all [N,J] lanes
    keyed (class, score desc) gives each class's head table. The pop loop
    then scores only the Dc class heads per step: `domain_pop` (the CUDA
    kernel on the card) for spread-only groups, `_affinity_pop` for groups
    with inter-pod affinity or anti-symmetry terms, as the reference routes
    its Pallas kernel.

    Returns (mono_ok, nodes i32[group_size], jidx i32[group_size], x i32[N])."""
    N, J, _ = traj.packed.shape
    dev = traj.packed.device
    fo = _filters_on(filter_on, dev)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    # partial8 lanes: the fold prefix BEFORE both coupled terms; the pop
    # loop adds w_ipa * ipa(class) and w_sp * sp(class), as combine_scores
    p8, feas = _lane_partials(
        ns, traj, pod, static_scores, static_ok, weights, fo, prefix_end=IPA_IDX,
    )
    score_lane = torch.where(feas, p8, _NEG_INF)
    mono_ok = (score_lane[:, 1:] <= score_lane[:, :-1]).all()

    # stable two-key sort (class asc, score desc, flat index asc): a stable
    # sort by score, then a stable sort by class
    combo = t(plan.combo_of_node, torch.int32)
    flat_combo = combo[:, None].expand(N, J).reshape(-1)
    neg = (-score_lane).reshape(-1)
    by_score = torch.sort(neg, stable=True).indices
    sidx = by_score[torch.sort(flat_combo[by_score], stable=True).indices]
    sneg = neg[sidx]
    counts = t(plan.counts, torch.int64)
    lane = torch.arange(l_cap, device=dev)
    gidx = (t(plan.offsets, torch.int64)[:, None] + lane[None, :]).clamp(0, N * J - 1)
    in_range = lane[None, :] < counts[:, None]
    hscore = torch.where(in_range, -sneg[gidx], _NEG_INF)  # [Dc,L]
    hflat = sidx[gidx]
    hnode = (hflat // J).to(torch.int32)
    hj = (hflat % J).to(torch.int32)
    cap_eff = counts.clamp(max=l_cap).to(torch.int32)

    st = _spread_tables(ns, carry0, pod, na_ok, flags)
    if _any_affinity(flags):
        nodes, jidxs = _affinity_pop(
            ns, carry0, pod, st, plan, hscore, hnode, hj, cap_eff, weights, fo,
            flags, valid_count, group_size,
        )
    else:
        C, D = st.base_dom.shape
        in_key = (
            st.in_key_cd.to(torch.float32) if flags.any_hard_spread
            else torch.zeros((C, D), dtype=torch.float32, device=dev)
        )
        nodes, jidxs = _dp.domain_pop(
            hscore.contiguous(), hnode.contiguous(), hj.contiguous(), cap_eff,
            t(plan.elig_combo), t(plan.combo_valid), st.base_dom.contiguous(),
            in_key.contiguous(), t(plan.t_onehot), st.match_c.contiguous(),
            st.active_c.to(torch.float32), st.hard_c.to(torch.float32),
            pod.spread_skew.contiguous(), t(plan.has_key),
            float(weights[SP_IDX]), bool(fo[F_SPREAD]), valid_count, group_size,
            flags.any_hard_spread, N,
        )
    x = torch.zeros(N, dtype=torch.int32, device=dev).index_add_(
        0, nodes.clamp(0, N - 1).long(), (nodes >= 0).to(torch.int32)
    )
    return mono_ok, nodes, jidxs, x


def _affinity_pop(
    ns, carry0, pod, st: SpreadTables, plan: DomainPlan, hscore, hnode, hj, cap_eff,
    weights, fo, flags: GroupFlags, valid_count: int, group_size: int,
):
    """The domain path's pop loop for groups with inter-pod affinity or
    anti-symmetry terms: the reference's scan step (fast.py domain_select),
    one iteration per pop, on the device with no host sync. Per pop it
    rebuilds the spread, affinity and anti-symmetry domain counts of every
    class from the commits per class y (exact integer sums), scores the class
    heads as (partial8 + w_ipa * ipa) + w_sp * sp, and pops the best head
    (ties to the lowest node). Returns (nodes i32[G], jidx i32[G])."""
    dev = hscore.device
    Dc, L = hscore.shape
    N = ns.valid.shape[0]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    w_sp, w_ipa = weights[SP_IDX], weights[IPA_IDX]
    valid_f = ns.valid.to(torch.float32)
    combo_valid = t(plan.combo_valid, torch.bool)
    elig_combo = t(plan.elig_combo)
    any_spread = flags.any_soft_spread or flags.any_hard_spread
    if any_spread:
        t_onehot = t(plan.t_onehot)
        has_key_cm = t(plan.has_key, torch.bool)
    if flags.any_req_aff or flags.any_pref_aff:
        # _domain_counts with elig=None counts over ALL valid nodes
        k_a = pod.aff_topo.clamp(min=0).long()
        to_a = ns.topo_onehot[k_a]                                # [CA,D,N]
        sel_a = pod.aff_sel.long()
        match_a = pod.match_sel[sel_a].to(torch.float32)
        counts0_a = torch.where(valid_f > 0, carry0.sel_counts[sel_a], 0.0)
        base_dom_a = (to_a * counts0_a[:, None, :]).sum(dim=2)    # [CA,D]
        in_key_a = (ns.domain_key[None, :] == k_a[:, None]) & ((to_a * valid_f).sum(dim=2) > 0.0)
        req_t = (pod.aff_topo >= 0) & pod.aff_required
        pref_t = (pod.aff_topo >= 0) & ~pod.aff_required
        self_match_a = pod.match_sel[sel_a]
        signed_w = torch.where(pod.aff_anti, -pod.aff_weight, pod.aff_weight)
        t_aff = t(plan.t_aff)
        has_key_aff = t(plan.has_key_aff, torch.bool)
    if flags.any_anti_sym:
        k_t = ns.anti_topo.clamp(min=0).long()
        to_t = ns.topo_onehot[k_t]                                # [AT,D,N]
        counts0_t = torch.where(valid_f > 0, carry0.anti_counts, 0.0)
        base_dom_t = (to_t * counts0_t[:, None, :]).sum(dim=2)    # [AT,D]
        active_sym = (ns.anti_topo >= 0) & pod.match_anti
        t_anti = t(plan.t_anti)
        has_key_anti = t(plan.has_key_anti, torch.bool)
    aff_on = ~fo[F_POD_AFFINITY]

    h = torch.zeros(Dc, dtype=torch.int64, device=dev)
    y = torch.zeros(Dc, dtype=torch.float32, device=dev)
    classes = torch.arange(Dc, device=dev)
    nodes, jidxs = [], []
    for _ in range(_active_steps(0, group_size, valid_count)):
        if any_spread:
            dom = st.base_dom + st.match_c[:, None] * (t_onehot * (y * elig_combo)).sum(dim=2)
            cnt_cm = (dom[:, :, None] * t_onehot).sum(dim=1)      # [C,Dc]
            raw = torch.where(st.active_c[:, None], cnt_cm, 0.0).sum(dim=0)
            sp = _spread_norm(raw, combo_valid)
        else:
            sp = torch.full((Dc,), 100.0, device=dev)
        hc = h.clamp(0, L - 1)[:, None]
        hs = torch.where(h < cap_eff, hscore.gather(1, hc)[:, 0], _NEG_INF)
        ipa = torch.zeros(Dc, dtype=torch.float32, device=dev)
        aff_ok = torch.ones(Dc, dtype=torch.bool, device=dev)
        if flags.any_req_aff or flags.any_pref_aff:
            dom_a = base_dom_a + match_a[:, None] * (t_aff * y).sum(dim=2)     # [CA,D]
            cnt_a = (dom_a[:, :, None] * t_aff).sum(dim=1)        # [CA,Dc]
            if flags.any_req_aff:
                total_a = torch.where(in_key_a, dom_a, 0.0).sum(dim=1)
                feasible = (
                    (cnt_a > 0) | (self_match_a[:, None] & (total_a[:, None] == 0))
                ) & has_key_aff
                ok_t = torch.where(pod.aff_anti[:, None], cnt_a == 0, feasible)
                aff_ok = aff_ok & torch.where(req_t[:, None], ok_t, True).all(dim=0)
            if flags.any_pref_aff:
                raw_a = torch.where(pref_t[:, None], signed_w[:, None] * cnt_a, 0.0).sum(dim=0)
                ipa = torch.where(pref_t.any(), _minmax_normalize(raw_a, combo_valid), 0.0)
        if flags.any_anti_sym:
            dom_t = base_dom_t + pod.own_anti[:, None] * (t_anti * y).sum(dim=2)
            cnt_t = (dom_t[:, :, None] * t_anti).sum(dim=1)       # [AT,Dc]
            ok_t = (cnt_t == 0) | ~has_key_anti
            aff_ok = aff_ok & torch.where(active_sym[:, None], ok_t, True).all(dim=0)

        total = (hs + w_ipa * ipa) + w_sp * sp
        if flags.any_hard_spread:
            spread_ok = _hard_spread_ok(
                dom, cnt_cm, st.in_key_cd, st.hard_c, pod.spread_skew, has_key_cm, fo[F_SPREAD],
            )
            total = torch.where(spread_ok, total, _NEG_INF)
        total = torch.where(aff_ok | aff_on, total, _NEG_INF)
        node_h = hnode.gather(1, hc)[:, 0]
        j_h = hj.gather(1, hc)[:, 0]
        mx_t = total.amax()
        m = torch.where(total == mx_t, node_h, N).argmin().view(1)
        ok = (mx_t > _NEG_INF).view(1)
        nodes.append(torch.where(ok, node_h.gather(0, m), -1))
        jidxs.append(torch.where(ok, j_h.gather(0, m), 0))
        oh = (classes == m) & ok
        h = h + oh.to(torch.int64)
        y = y + oh.to(torch.float32)
    return _step_outputs(nodes, group_size, -1, dev), _step_outputs(jidxs, group_size, 0, dev)


def light_reasons(
    ns: NodeStatic,
    carry0: Carry,
    pod: PodRow,
    static_ok: torch.Tensor,
    static_ff: torch.Tensor,
    static_scores: dict,
    na_ok: torch.Tensor,
    weights: torch.Tensor,
    x: torch.Tensor,
    cur: torch.Tensor,
    filter_on=None,
    flags: GroupFlags = ALL_DYNAMIC,
) -> torch.Tensor:
    """Failure-reason histogram i32[F] at state (x, cur): one row for the
    group's whole failure suffix (a failed step commits nothing)."""
    fo = _filters_on(filter_on, x.device)
    _, p = _light_eval(
        ns, carry0, pod, static_ok, static_scores, na_ok, weights, fo, x, cur,
        flags, _hoisted_values(ns, pod, cur, flags),
    )
    first_fail = torch.full_like(static_ff, NUM_FILTERS)
    for bad, f in (
        (~p["gpu_ok"], F_GPU), (~p["storage_ok"], F_STORAGE),
        (~p["aff_ok"], F_POD_AFFINITY), (~p["spread_ok"], F_SPREAD),
        (p["res_fail"], F_RESOURCES), (~p["port_ok"], F_NODE_PORTS),
    ):
        first_fail = torch.where(bad, f, first_fail)
    first_fail = torch.where(static_ff < NUM_FILTERS, static_ff, first_fail)
    return reason_row(first_fail, ns.valid)


def gather_takes(traj: Trajectory, nodes: torch.Tensor, jidxs: torch.Tensor):
    """Per-pod allocation takes from (chosen node, commit index)."""
    N = traj.packed.shape[0]
    node_c = nodes.clamp(0, N - 1).long()
    j = jidxs.long()
    placed = (nodes >= 0)[:, None]
    return tuple(
        torch.where(placed, a[node_c, j], 0.0)
        for a in (traj.gpu_take, traj.vg_take, traj.dev_take)
    )


def exit_carry(
    ns: NodeStatic, carry0: Carry, pod: PodRow, traj: Trajectory, x: torch.Tensor
) -> Carry:
    """Fold the group's commits (x per node) back into a Carry: node-local
    rows come from the trajectory, count tables are base + add * x."""
    xf = x.to(torch.float32)
    add_any, add_wild, add_ipc = port_adds(
        carry0.port_any.shape[0], carry0.port_ipc.shape[0], pod
    )
    return Carry(
        free=_sel_j(traj.free, x),
        sel_counts=carry0.sel_counts + pod.match_sel.to(torch.float32)[:, None] * xf[None, :],
        gpu_free=_sel_j(traj.gpu_free, x),
        vg_free=_sel_j(traj.vg_free, x),
        dev_free=_sel_j(traj.dev_free, x),
        port_any=carry0.port_any + add_any[:, None] * xf[None, :],
        port_wild=carry0.port_wild + add_wild[:, None] * xf[None, :],
        port_ipc=carry0.port_ipc + add_ipc[:, None] * xf[None, :],
        anti_counts=carry0.anti_counts + pod.own_anti[:, None] * xf[None, :],
    )


def _traj_len(free_np: np.ndarray, valid_np: np.ndarray, req_np: np.ndarray, length: int):
    """Trajectory length for this group: the most commits any node can
    locally absorb + slack, capped by group size."""
    pos = req_np > 1e-9
    if not pos.any():
        return None
    caps = np.floor((free_np[:, pos] + _EPS) / req_np[pos]).min(axis=1)
    caps = np.clip(caps, 0.0, None)
    caps = caps[valid_np[: caps.shape[0]]]
    c_max = float(caps.max()) if caps.size else 0.0
    if not np.isfinite(c_max):
        return None
    return int(min(c_max + 2, length + 1))


def _bucket_j(j: int) -> int:
    return 1 << max(int(j) - 1, 7).bit_length()


def _bucket_light(n: int) -> int:
    """Pop-count bucket: 32-granular up to 2048, then 2048-granular."""
    if n <= 2048:
        return _bucket(n)
    return (n + 2047) // 2048 * 2048


def _same_device(have: torch.device, want: torch.device) -> bool:
    return have.type == want.type and (want.index is None or have.index == want.index)


def schedule_batch_fast(
    ns: NodeStatic,
    carry: Carry,
    batch: PodBatch,
    weights,
    max_group_chunk: int = DEFAULT_GROUP_CHUNK,
    force_fast: bool = False,
    filter_on=None,
    extra_filters=(),
    extra_scores=(),
    device=DEFAULT_DEVICE,
    timings: Optional[dict] = None,
) -> Tuple[Carry, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Schedule a pod batch group by group: the trajectory fast path where
    it amortizes, the per-pod grouped scan elsewhere.

    Returns (carry, nodes i32[P], reasons i32[P,F], gpu_take i32[P,G],
    vg_take f32[P,V], dev_take f32[P,DV]), bit-identical to the JAX
    package's schedule_batch_fast. `ns`/`carry` must live on `device`.
    `max_group_chunk` bounds the pods of one scan call; `force_fast`
    disables the amortization heuristic. Out-of-tree plugins
    (`extra_filters` predicates, `extra_scores` (fn, weight) pairs) may read
    the carry arbitrarily, which voids the trajectory's premise: any plugin
    sends the whole batch through the grouped path.

    `timings`, when given, accumulates wall seconds per phase (trajectory,
    select, tail; grouped for the grouped route's groups) and, per route,
    the select seconds `select.<route>` and the steps run `steps.<route>`,
    synchronizing the device at each phase boundary."""
    dev = resolve_device(device)
    if not _same_device(ns.valid.device, dev) or not _same_device(carry.free.device, dev):
        raise ValueError(
            f"state lives on {ns.valid.device}/{carry.free.device}, "
            f"but device={dev} was asked for"
        )
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    if filter_on is not None:
        filter_on = torch.as_tensor(filter_on, dtype=torch.bool).to(dev)
    outs = _empty_outputs(ns, batch.p)
    rows_all = pod_rows_from_batch(batch, dev)
    N = ns.valid.shape[0]
    valid_np = ns.valid.cpu().numpy()

    # a disabled NodeResourcesFit filter voids the trajectory-length bound;
    # so does any out-of-tree plugin
    res_filter_on = (
        filter_on is None or bool(filter_on[F_RESOURCES])
    ) and not extra_filters and not extra_scores
    free_entry = carry.free.cpu().numpy() if res_filter_on else None
    anti_topo_np = ns.anti_topo.cpu().numpy()
    topo_np = ns.topo.cpu().numpy()
    n_domains = int(ns.topo_onehot.shape[1])

    clock = [time.perf_counter()]

    def phase(name, route=None, steps=0):
        if timings is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[name] = timings.get(name, 0.0) + now - clock[0]
        if route is not None:
            timings[f"select.{route}"] = timings.get(f"select.{route}", 0.0) + now - clock[0]
            timings[f"steps.{route}"] = timings.get(f"steps.{route}", 0) + steps
        clock[0] = now

    for start, length in group_runs(batch):
        if timings is not None:
            clock[0] = time.perf_counter()
        row = PodRow(*(a[start] for a in rows_all))
        flags = group_flags(
            {f: getattr(batch, f)[start] for f in (
                "hp_pid", "has_local", "gpu_mem", "spread_topo", "spread_hard",
                "aff_topo", "aff_required", "match_anti",
            )},
            anti_topo_np,
        )
        j_need = (
            _traj_len(free_entry, valid_np, batch.req[start], length)
            if free_entry is not None and (force_fast or length >= 64)
            else None
        )
        # break-even: the trajectory costs ~j_need heavy steps, the grouped
        # scan one heavy step per pod
        use_fast = (
            j_need is not None
            and _bucket_j(j_need) <= J_CAP
            and (force_fast or length >= max(3 * j_need // 2, 64))
        )
        if not use_fast:
            _count_path("grouped")
            carry = _grouped_run(
                ns, carry, row, start, length, weights, max_group_chunk, filter_on,
                extra_filters, extra_scores, outs,
            )
            phase("grouped", "grouped", length)
            continue

        j_steps = _bucket_j(j_need)
        traj, static_ok, static_ff, static_scores, na_ok = build_trajectory(
            ns, carry, row, weights, j_steps, filter_on, flags
        )
        phase("trajectory")
        sl = slice(start, start + length)

        def finish(nodes_d, jidx_d, x_d, mono_d=None):
            """The group's whole tail (takes, failure-suffix reason row,
            exit carry), with every host-needed value and the sort/domain
            mono verdict fetched in ONE transfer; on a False verdict the
            caller discards it all and replays with a scan."""
            take_d, vg_d, dev_d = gather_takes(traj, nodes_d, jidx_d)
            reason_d = light_reasons(
                ns, carry, row, static_ok, static_ff, static_scores, na_ok, weights,
                x_d, cur_at(traj, x_d), filter_on, flags,
            )
            carry_d = exit_carry(ns, carry, row, traj, x_d)
            mono = torch.ones((), dtype=torch.bool, device=dev) if mono_d is None else mono_d
            mono_np, *got = fetch(mono, nodes_d, take_d, vg_d, dev_d, reason_d)
            return bool(mono_np), got, carry_d

        def commit(got, carry_d):
            nonlocal carry
            nodes_np, take_np, vg_np, dev_np, reason_np = got
            outs[0][sl] = nodes_np
            outs[2][sl] = take_np.astype(np.int32)
            outs[3][sl] = vg_np
            outs[4][sl] = dev_np
            if (nodes_np < 0).any():
                # a failed step commits nothing: one reason row covers the suffix
                outs[1][sl][nodes_np < 0] = reason_np
            carry = carry_d

        committed = False
        out_size = _bucket_light(length)
        if _sortable(flags) and out_size <= N * j_steps:
            mono, nodes_d, jidx_d, x = sort_select(
                ns, traj, row, static_ok, static_scores, weights, length,
                out_size, filter_on,
            )
            phase("select", "sort")
            mono_ok, got, carry_d = finish(nodes_d[:length], jidx_d[:length], x, mono)
            if mono_ok:
                _count_path("sort")
                commit(got, carry_d)
                committed = True
            else:
                # a rising score sequence voids the merge: replay with a scan
                _count_path("sort_fallback")

        if not committed and flags.domain_aff:
            # the class partition is planned on the host from the pod's
            # spread eligibility (one bool[N] transfer per group)
            elig_np = na_ok.cpu().numpy() & valid_np
            plan = _domain_plan(
                batch.spread_topo[start], batch.aff_topo[start], anti_topo_np,
                batch.match_anti[start], topo_np, valid_np, elig_np, j_steps,
                n_domains,
            )
            if plan is not None:
                g = _bucket_light(length)
                l_cap = _bucket_light(min(int(plan.counts.max()), length))
                launched = _dp.thread_launches()
                mono, nodes_d, jidx_d, x = domain_select(
                    ns, traj, carry, row, static_ok, static_scores, na_ok, weights,
                    plan, g, l_cap, length, filter_on, flags,
                )
                _count_path("domain_kernel", _dp.thread_launches() - launched)
                affinity = _any_affinity(flags)
                phase("select", "domain_affinity" if affinity else "domain",
                      min(g, length) if affinity else 0)
                mono_ok, got, carry_d = finish(nodes_d[:length], jidx_d[:length], x, mono)
                if mono_ok:
                    _count_path("domain")
                    commit(got, carry_d)
                    committed = True
                else:
                    # a rising lane sequence voids the within-class merge
                    _count_path("domain_fallback")

        if not committed:
            route = "micro" if flags.micro_spread else "scan"
            _count_path(route)
            x = torch.zeros(N, dtype=torch.int32, device=dev)
            chunks, done, steps = [], 0, 0
            while done < length:
                n = min(length - done, max_group_chunk)
                g = _bucket_light(n)
                x, nodes_d, jidx_d = light_scan(
                    ns, traj, carry, row, static_ok, static_scores, na_ok, weights,
                    x, done, g, length, filter_on, flags,
                )
                steps += _active_steps(done, g, length)
                chunks.append((nodes_d[:n], jidx_d[:n]))
                done += n
            phase("select", route, steps)
            _, got, carry_d = finish(
                torch.cat([c[0] for c in chunks]), torch.cat([c[1] for c in chunks]), x,
            )
            commit(got, carry_d)
        phase("tail")

    return (carry,) + outs


# ---------------------------------------------------------------------------
# Scenario axis: S lanes over one shared node table
# ---------------------------------------------------------------------------

# Lanes of every batched call pad to a multiple of this (pad lanes are copies
# of lane 0, results discarded), as the reference pads its scenario axis.
SCENARIO_BUCKET = 8


def scenario_bucket(s: int, floor: int = 0) -> int:
    """Padded lane count for `s` real lanes; `floor` (itself a padded count)
    keeps a session's widest shape across consecutive calls."""
    return round_up(max(int(s), 1, int(floor)), SCENARIO_BUCKET)


# (N, P) shape key -> padded lane counts seen through schedule_scenarios_host
_SCENARIO_PROGRAMS: dict = {}


def scenario_programs() -> dict:
    """Snapshot of {(n_nodes, n_pods): {padded lane counts}} so far."""
    return {k: set(v) for k, v in list(_SCENARIO_PROGRAMS.items())}


def reset_scenario_programs() -> None:
    _SCENARIO_PROGRAMS.clear()


def commit_chunk_size() -> int:
    """Pods per chunk of the chunked scenario scan (`OSIM_COMMIT_CHUNK`);
    0, the default, runs the whole batch as one scan."""
    try:
        return max(0, int(os.environ.get("OSIM_COMMIT_CHUNK", "0") or 0))
    except ValueError:
        return 0


def _scenario_step(ns: NodeStatic, filter_on):
    """schedule_step on S lanes: each lane has its own valid mask, score
    weights and carry; the pod and its topology keys are shared."""

    def one(valid, weights, carry, pod, keys):
        return schedule_step(ns._replace(valid=valid), weights, carry, pod, filter_on, (), (), keys)

    return torch.func.vmap(one, in_dims=(0, 0, 0, None, None))


def schedule_scenarios(
    ns: NodeStatic,
    carry_s: Carry,
    pods: PodRow,
    weights_s: torch.Tensor,
    valid_s: torch.Tensor,
    filter_on=None,
):
    """The sequential commit scan on S lanes: one Python loop over the pods,
    each step `schedule_step` under `torch.func.vmap` over the lanes.

    Lanes share the node table `ns` and the pod sequence; each has its own
    valid mask `valid_s` bool[S,N], weights `weights_s` f32[S,W] and carry
    (every leaf stacked on axis 0). A row that is real but invalid in a lane
    is inert in every filter, score and commit, so lane s equals a serial
    scan over a table whose valid mask is valid_s[s].

    Returns (carry_s, nodes i32[S,P], reasons i32[S,P,F], gpu_take
    i32[S,P,G], vg_take f32[S,P,V], dev_take f32[S,P,DV]) as tensors."""
    step = _scenario_step(ns, filter_on)
    outs = []
    for i in range(pods.req.shape[0]):
        pod = PodRow(*(a[i] for a in pods))
        carry_s, out = step(valid_s, weights_s, carry_s, pod, pod_keys(ns, pod))
        outs.append(out)
    return (carry_s,) + tuple(torch.stack(col, dim=1) for col in zip(*outs))


def schedule_scenarios_chunked(
    ns: NodeStatic,
    carry_s: Carry,
    pods: PodRow,
    weights_s: torch.Tensor,
    valid_s: torch.Tensor,
    count: int,
    filter_on=None,
):
    """One chunk of the scenario scan, count-gated: only the first `count`
    pods of the chunk step (the reference masks the carry writes of the
    rest, which leaves the carry as it was); outputs cover those pods."""
    return schedule_scenarios(
        ns, carry_s, PodRow(*(a[:count] for a in pods)), weights_s, valid_s, filter_on
    )


def schedule_wave(
    ns: NodeStatic,
    carry_s: Carry,
    pods: PodRow,
    weights_s: torch.Tensor,
    valid_s: torch.Tensor,
    choices_s: torch.Tensor,
    count: Optional[int],
    parts,
    filter_on=None,
):
    """One conflict-parallel commit round over a wave of W pods on S lanes
    (ops/wave.py's Jacobi step). On the converged round (returned choices
    equal `choices_s`) every output is bitwise the serial scan's over the
    same wave. `carry_s` is only read. Returns (carry_s, choices i32[S,W],
    reasons i32[S,W,F], gpu_take i32[S,W,G], vg_take f32[S,W,V], dev_take
    f32[S,W,DV])."""
    return _wave.wave_round(
        ns, weights_s, valid_s, carry_s, pods, choices_s, count, parts, filter_on
    )


def commit_choices(
    ns: NodeStatic,
    carry_s: Carry,
    pods: PodRow,
    choices_s: torch.Tensor,
    count: Optional[int] = None,
):
    """The wave engine's commit phase alone: replay decided choices i32[S,W]
    (-1 = no commit; pods from `count` on never commit) through the row
    commit. Returns (carry_s, gpu_take i32[S,W,G], vg_take f32[S,W,V],
    dev_take f32[S,W,DV])."""
    W = choices_s.shape[1]
    takes = []
    for w in range(W):
        pod = PodRow(*(a[w] for a in pods))
        ch = choices_s[:, w] if count is None or w < count else torch.full_like(choices_s[:, w], -1)
        carry_s, g, v, d = commit_choices_lanes(ns, carry_s, pod, ch)
        takes.append((g.to(torch.int32), v, d))
    return (carry_s,) + tuple(torch.stack(col, dim=1) for col in zip(*takes))


def _universe_step(filter_on):
    """schedule_step on S universes: every leaf of the node table, weights,
    carry and pod varies per lane, so the pod's topology keys are computed
    inside the vmapped function, against its own lane's table."""

    def one(ns, weights, carry, pod):
        return schedule_step(ns, weights, carry, pod, filter_on, (), (), pod_keys(ns, pod))

    return torch.func.vmap(one)


def schedule_universes(
    ns_s: NodeStatic,
    carry_s: Carry,
    pods_s: PodRow,
    weights_s: torch.Tensor,
    filter_on=None,
):
    """The sequential commit scan on S whole universes: every NodeStatic,
    Carry and PodRow leaf stacked on axis 0 (0-d leaves widened to [S]),
    `pods_s` [S, P, ...] and `weights_s` [S, W]. One Python loop over the P
    pods, each step `schedule_step` under `torch.func.vmap` over the lanes,
    so lane u equals a serial schedule_batch over universe u's table.

    Returns (carry_s, nodes i32[S,P], reasons i32[S,P,F], gpu_take
    i32[S,P,G], vg_take f32[S,P,V], dev_take f32[S,P,DV]) as tensors."""
    step = _universe_step(filter_on)
    outs = []
    for i in range(pods_s.req.shape[1]):
        pod = PodRow(*(a[:, i] for a in pods_s))
        carry_s, out = step(ns_s, weights_s, carry_s, pod)
        outs.append(out)
    return (carry_s,) + tuple(torch.stack(col, dim=1) for col in zip(*outs))


def universe_parts(pods_s: PodRow) -> list:
    """Per pod position w, the carry parts pod w of ANY universe can change
    (kernels.commit_parts over the lane axis)."""
    fields = ("match_sel", "own_anti", "gpu_mem", "gpu_num", "lvm_req", "dev_req", "hp_pid")
    by_pos = {f: np.swapaxes(getattr(pods_s, f).cpu().numpy(), 0, 1) for f in fields}
    return [commit_parts(by_pos, w) for w in range(pods_s.req.shape[1])]


def schedule_universes_wave_host(
    ns_s: NodeStatic,
    carry_s: Carry,
    pods_s: PodRow,
    weights_s: torch.Tensor,
    filter_on=None,
):
    """Drive the wave round body (ops/wave.py universe_round: one Jacobi
    round for S whole universes, the whole pod sequence as a single wave,
    no count gate) to its fixpoint: the same arguments and return tuple as
    schedule_universes. The input carry is re-read by every round and the
    converged round's exit carry is returned. A chunk
    converges within P + 1 rounds (ops/wave.py); one still moving after that
    falls back to schedule_universes from its input carry (counted in
    osim_wave_fallbacks_total{reason="universes_max_rounds"})."""
    s_pad, p_pad = pods_s.req.shape[:2]
    parts = universe_parts(pods_s)
    choices = torch.full((s_pad, p_pad), -1, dtype=torch.int32, device=pods_s.req.device)
    prev = np.full((s_pad, p_pad), -1, np.int32)
    rounds = 0
    while True:
        rounds += 1
        _progress(f"universes-wave S={s_pad} P={p_pad} round {rounds}")
        carry_w, choices_new, *out = _wave.universe_round(
            ns_s, weights_s, carry_s, pods_s, choices, parts, filter_on
        )
        ch = choices_new.cpu().numpy()
        if np.array_equal(ch, prev):
            break
        if rounds > 1:
            _metrics.WAVE_CONFLICTS.inc(int((ch != prev).sum()))
        if rounds > p_pad + 1:
            _metrics.WAVE_FALLBACKS.inc(reason="universes_max_rounds")
            return schedule_universes(ns_s, carry_s, pods_s, weights_s, filter_on)
        choices, prev = choices_new, ch
    _metrics.COMMIT_ROUNDS.observe(rounds)
    return (carry_w, choices_new) + tuple(out)


def scenario_carry_digest(carry_s: Carry) -> int:
    """Digest of a (stacked) carry: one device `digest_fold` per leaf,
    chained in Carry._fields order; equal to scenario_carry_digest_host of
    the same leaves on the host, and to the reference's."""
    parts = torch.stack([_delta.digest_fold(getattr(carry_s, f)) for f in Carry._fields])
    return _delta.combine_digests(parts.cpu().tolist())


def scenario_carry_digest_host(leaves: dict) -> int:
    """Host twin of scenario_carry_digest over {field: np.ndarray} leaves."""
    return _delta.combine_digests(
        _delta.digest_fold_host(np.asarray(leaves[f])) for f in Carry._fields
    )


def carry_to_host(carry_s: Carry) -> dict:
    """Every Carry leaf on the host -> {field: np.ndarray}."""
    return {f: getattr(carry_s, f).cpu().numpy() for f in Carry._fields}


def carry_from_host(carry_s: Carry, leaves: dict) -> Carry:
    """Host snapshot leaves ({field: np.ndarray}) back on the device of
    `carry_s`, the carry the resuming (or recovering) process built; only
    its leaves' shapes and devices are used. A leaf whose shape differs
    raises ValueError: the snapshot is from another plan shape. (The
    reference also re-pins onto a mesh's shardings; the port has no mesh
    yet, ROADMAP.md item 13b.)"""
    for f in Carry._fields:
        want = tuple(getattr(carry_s, f).shape)
        have = tuple(np.asarray(leaves[f]).shape)
        if want != have:
            raise ValueError(
                f"carry snapshot leaf {f!r} has shape {have}, current plan "
                f"expects {want} — snapshot is from a different plan shape"
            )
    return Carry(*(
        torch.from_numpy(np.array(leaves[f], copy=True)).to(getattr(carry_s, f).device)
        for f in Carry._fields
    ))


def _to_host(tensors) -> tuple:
    return tuple(t.cpu().numpy() for t in tensors)


def schedule_scenarios_host(
    ns: NodeStatic,
    carry_s: Carry,
    batch: PodBatch,
    weights_s: torch.Tensor,
    valid_s: torch.Tensor,
    s_real: int,
    filter_on=None,
):
    """Host driver for one batched call over a pod batch. Returns (carry_s,
    nodes, reasons, gpu_take, vg_take, dev_take), the outputs as numpy
    arrays trimmed to the `s_real` live lanes and the batch's real pods.
    `carry_s` / `weights_s` / `valid_s` are padded to
    scenario_bucket(s_real) (pad lanes copy lane 0); the returned carry
    keeps the padded lanes so it threads into the next call.

    Routes, as the reference's: the wave driver when ops.wave.wave_enabled
    (on a CUDA device, auto mode takes it from 512 pods on); else, with
    OSIM_COMMIT_CHUNK > 0 and more pods than a chunk, the chunked scan;
    else one scan. All three give the same bits."""
    dev = valid_s.device
    p_real = int(batch.p)
    rows = PodRow(*(t[:p_real] for t in pod_rows_from_batch(batch, dev)))
    s_pad = int(valid_s.shape[0])
    _SCENARIO_PROGRAMS.setdefault((int(ns.valid.shape[0]), p_real), set()).add(s_pad)
    _metrics.SCENARIOS_PER_CALL.observe(s_real)
    if _wave.wave_enabled(p_real, dev):
        return _schedule_scenarios_wave_host(
            ns, carry_s, rows, batch, weights_s, valid_s, s_real, s_pad,
            p_real, _wave.wave_size(), filter_on,
        )
    chunk = commit_chunk_size()
    if chunk and p_real > chunk:
        return _schedule_scenarios_chunked_host(
            ns, carry_s, rows, weights_s, valid_s, s_real, s_pad, p_real, chunk, filter_on,
        )
    _progress(f"scenarios S={s_real}/{s_pad} P={p_real} N={ns.valid.shape[0]}")
    carry_s, *outs = schedule_scenarios(ns, carry_s, rows, weights_s, valid_s, filter_on)
    return (carry_s,) + tuple(a[:s_real] for a in _to_host(outs))


def _progress(msg: str) -> None:
    _log.debug("%s", msg)


def _pad_rows(rows: PodRow, p_pad: int) -> PodRow:
    """Pod rows padded to `p_pad` with copies of row 0 (the count gate
    keeps pad steps out of the carry)."""
    p_real = int(rows.req.shape[0])
    if p_pad == p_real:
        return rows
    return PodRow(*(torch.cat([a, a[:1].expand((p_pad - p_real,) + a.shape[1:])]) for a in rows))


class _PlanDriver:
    """What the chunked and wave drivers share around their chunk loop:
    the active checkpointer's plan (restore of a verified snapshot, a
    `plan_chunk` record and a periodic snapshot per chunk, the final
    `plan_done`), the `device` fault point before each chunk, and the
    device-loss rollback to the last good carry (in memory, or the last
    snapshot), which restores the carry and truncates the outputs. A third
    strike re-raises DeviceLostError."""

    def __init__(self, N, p_real, s_pad, chunk, n_chunks):
        from ..durable import checkpoint as _checkpoint
        from ..resilience import faults as _faults
        from ..utils import flightrec as _flightrec

        self.faults, self.flightrec = _faults, _flightrec
        self.cp = _checkpoint.active_checkpointer()
        self.plan = None
        self.start = 0
        self.outs: list = []  # host (nodes, reasons, gpu, vg, dev) tuples, in order
        if self.cp is not None:
            self.plan = self.cp.begin_plan(
                n_nodes=N, p_real=p_real, s_pad=s_pad, chunk=chunk, n_chunks=n_chunks,
            )
        self.last_good = None  # (chunk index, host carry leaves, len(outs), digest)
        self.strikes = 0

    @property
    def run_dir(self):
        return self.cp.run_dir if self.cp is not None else None

    def restore(self, carry_s: Carry) -> Carry:
        """Put a verified snapshot back (its chunks are skipped), and take
        the in-memory rollback point when a checkpointer or a device fault
        rule can need it."""
        restore = self.plan.restore if self.plan is not None else None
        if restore is not None:
            self.start = restore.chunks_done
            carry_s = carry_from_host(carry_s, restore.carry)
            self.outs.append(restore.outputs)
            _metrics.RESUME_CHUNKS_SKIPPED.inc(self.start)
            self.flightrec.note("plan-restore", plan=self.plan.key, chunk=self.start - 1,
                                digest=f"{restore.digest:08x}")
            self.flightrec.dump("chunk-restore", run_dir=self.run_dir)
        if self.cp is not None or self.faults.has_rules("device"):
            host0 = carry_to_host(carry_s)
            self.last_good = (self.start, host0, len(self.outs), scenario_carry_digest_host(host0))
        return carry_s

    def device_fault(self, i: int, carry_s: Carry):
        """The `device` fault point before chunk i: None to run chunk i, or
        (chunk to go back to, restored carry) after a recovered loss."""
        rule = self.faults.maybe_inject("device", f"commit-chunk:{i}")
        if rule is None:
            return None
        try:
            self.faults.apply_device_fault(rule)
            return None
        except self.faults.DeviceLostError:
            self.strikes += 1
            if self.last_good is None or self.strikes >= 3:
                _metrics.DEVICE_LOST.inc(handled="no")
                raise
            _metrics.DEVICE_LOST.inc(handled="yes")
            g_chunk, g_carry, g_outs, g_digest = self.last_good
            self.flightrec.note("device-lost", chunk=i, restored_to=g_chunk,
                                digest=f"{g_digest:08x}")
            self.flightrec.dump("device-lost", run_dir=self.run_dir)
            del self.outs[g_outs:]
            return g_chunk, carry_from_host(carry_s, g_carry)

    def chunk_done(self, i: int, pods_done: int, carry_s: Carry) -> None:
        _metrics.PLAN_CHUNKS.inc()
        if self.cp is not None:
            digest = scenario_carry_digest(carry_s)
            hostc = self.cp.on_chunk(self.plan, i, pods_done, digest, carry_s, self.outs)
            if hostc is not None:
                self.last_good = (i + 1, hostc, len(self.outs), digest)

    def finish(self, carry_s: Carry, s_real: int):
        if self.cp is not None:
            self.cp.finish_plan(self.plan, scenario_carry_digest(carry_s))
        cat = tuple(np.concatenate([o[k] for o in self.outs], axis=1) for k in range(5))
        return (carry_s,) + tuple(a[:s_real] for a in cat)


def _schedule_scenarios_chunked_host(
    ns, carry_s, rows, weights_s, valid_s, s_real, s_pad, p_real, chunk, filter_on=None,
):
    """The chunked scan's host loop: ceil(P/C) count-gated chunk calls whose
    chained result equals the single scan, over rows padded to whole
    chunks. Between chunks, the checkpoint hooks and the device-fault
    recovery of _PlanDriver; on resume only the chunks a verified snapshot
    does not cover run again, each digest-checked against the journal."""
    N = int(ns.valid.shape[0])
    n_chunks = -(-p_real // chunk)
    rows = _pad_rows(rows, n_chunks * chunk)
    _SCENARIO_PROGRAMS.setdefault((N, chunk), set()).add(s_pad)
    drv = _PlanDriver(N, p_real, s_pad, chunk, n_chunks)
    carry_s = drv.restore(carry_s)
    i = drv.start
    while i < n_chunks:
        back = drv.device_fault(i, carry_s)
        if back is not None:
            i, carry_s = back
            continue
        lo = i * chunk
        count = min(chunk, p_real - lo)
        _progress(f"scenarios S={s_real}/{s_pad} N={N} chunk {i + 1}/{n_chunks} "
                  f"(C={chunk}, live={count})")
        carry_s, *out = schedule_scenarios_chunked(
            ns, carry_s, PodRow(*(a[lo:lo + chunk] for a in rows)),
            weights_s, valid_s, count, filter_on,
        )
        drv.outs.append(_to_host(out))
        drv.chunk_done(i, lo + count, carry_s)
        i += 1
    return drv.finish(carry_s, s_real)


def _schedule_scenarios_wave_host(
    ns, carry_s, rows, batch, weights_s, valid_s, s_real, s_pad, p_real, wave, filter_on=None,
):
    """The wave driver's host loop: per wave of `wave` pods, run
    schedule_wave rounds until the probe reproduces its input choices (the
    fixpoint, bitwise the serial scan), then adopt that round's exit carry
    and outputs. A wave still moving after OSIM_WAVE_ROUNDS rounds is re-run
    through the serial chunked scan from its input carry (counted in
    osim_wave_fallbacks_total). Durability is the chunked driver's: one
    `plan_chunk` record per committed wave with the digest chain a chunked
    run of C = wave journals, and a device loss rolls back to the last good
    committed wave (rounds change nothing until a fixpoint is adopted)."""
    N = int(ns.valid.shape[0])
    n_waves = -(-p_real // wave)
    rows = _pad_rows(rows, n_waves * wave)
    _SCENARIO_PROGRAMS.setdefault((N, wave), set()).add(s_pad)
    max_rounds = _wave.wave_max_rounds()
    rows_np = {f: np.asarray(getattr(batch, f)) for f in ("match_sel", "own_anti", "gpu_mem",
                                                           "gpu_num", "lvm_req", "dev_req", "hp_pid")}
    parts_all = [commit_parts(rows_np, i) for i in range(p_real)]
    dev = valid_s.device
    drv = _PlanDriver(N, p_real, s_pad, wave, n_waves)
    carry_s = drv.restore(carry_s)
    i = drv.start
    while i < n_waves:
        back = drv.device_fault(i, carry_s)
        if back is not None:
            i, carry_s = back
            continue
        lo = i * wave
        count = min(wave, p_real - lo)
        rows_w = PodRow(*(a[lo:lo + count] for a in rows))
        parts = parts_all[lo:lo + count]
        choices = torch.full((s_pad, count), -1, dtype=torch.int32, device=dev)
        prev = np.full((s_pad, count), -1, np.int32)
        rounds = 0
        converged = False
        while True:
            rounds += 1
            _progress(f"scenarios S={s_real}/{s_pad} N={N} wave {i + 1}/{n_waves} "
                      f"round {rounds} (W={wave}, live={count})")
            carry_w, choices_new, *out = schedule_wave(
                ns, carry_s, rows_w, weights_s, valid_s, choices, None, parts, filter_on,
            )
            ch = choices_new.cpu().numpy()
            if np.array_equal(ch, prev):
                converged = True
                break
            if rounds > 1:
                _metrics.WAVE_CONFLICTS.inc(int((ch[:s_real] != prev[:s_real]).sum()))
            if max_rounds and rounds >= max_rounds:
                break
            choices, prev = choices_new, ch
        _metrics.COMMIT_ROUNDS.observe(rounds)
        if converged:
            carry_s = carry_w
            drv.outs.append((np.ascontiguousarray(ch),) + _to_host(out))
        else:
            _metrics.WAVE_FALLBACKS.inc(reason="max_rounds")
            _progress(f"wave {i + 1}/{n_waves}: no fixpoint in {rounds} rounds; "
                      "replaying through the serial chunked scan")
            carry_s, *out = schedule_scenarios_chunked(
                ns, carry_s, rows_w, weights_s, valid_s, count, filter_on,
            )
            drv.outs.append(_to_host(out))
        drv.chunk_done(i, lo + count, carry_s)
        i += 1
    return drv.finish(carry_s, s_real)
