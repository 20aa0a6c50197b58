"""Trajectory-accelerated grouped scheduling: the batched fast path.

The port of the JAX package's ops/fast.py for the headline scheduling path.
While a group of IDENTICAL pods schedules, a node's local state changes only
when that node is chosen, so for one group:

  1. `build_trajectory` virtually commits the pod to EVERY node J times,
     recording per-step node-local masks, raw scores and allocation takes
     ([N,J,...] tables).
  2. Selection then needs only each node's commit count x:
     - the SORT path (`sort_select`): purely node-local scores make the
       sequential argmax a k-way merge, i.e. one stable sort of all [N,J]
       lanes;
     - the DOMAIN-MERGE path (`domain_select`): with topology spread over
       non-hostname keys, nodes fall into a few combined domain classes; one
       stable sort keyed (class, score) orders every class's lanes, and a
       sequential pop loop over the class heads (`ops.domain_pop`, a CUDA
       kernel on the card) picks the winner of each step.
  3. The group tail (`gather_takes`, `cur_at` -> `light_reasons`,
     `exit_carry`) folds the commits back into the carry.

Placements, failure reasons, allocation takes and the exit carry are
bit-identical to the JAX package's `schedule_batch_fast`. Routes this port
does not cover yet raise NotImplementedError naming their ROADMAP item: the
per-pod grouped path for small or deep groups, the light/micro scans (the
sort and domain fallbacks and groups neither path takes), and groups with
inter-pod (anti-)affinity terms.

Exactness traps handled here (besides those of ops/kernels.py):
  - `torch.sort(..., stable=True)` reproduces jnp.argsort / lax.sort's
    stable order; the domain path's two-key sort is a stable sort by score
    followed by a stable sort by class;
  - `_sel_j` gathers one lane per node instead of the reference's one-hot
    sum, adding +0.0 so a -0.0 lane reads back as +0.0 like the sum does;
  - feasibility and partial scores are selected separately, so no
    `-inf * 0` NaN appears;
  - scatter-adds are `index_add_` on int32.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import domain_pop as _dp
from .domain_pop import _spread_norm
from .encode import PodBatch
from .grouped import _bucket, _static_parts, group_runs
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
    _domain_counts,
    _minmax_normalize,
    combine_scores,
    gpu_allocate_rowwise,
    gpu_mask,
    gpu_share_raw,
    local_storage_eval,
    port_adds,
    ports_mask,
    resource_fail,
)
from .state import pod_rows_from_batch

# Trajectories longer than this take the per-pod grouped path.
J_CAP = 512

# Max combined (domain-tuple, eligibility) classes for the domain-merge path.
DM_CAP = 64

# Groups scheduled per strategy since import; "domain_kernel" counts the
# domain groups whose pop loop ran as the CUDA kernel.
PATH_COUNTS = {"sort": 0, "domain": 0, "domain_kernel": 0}

# ROADMAP items named by the routes this port does not cover yet.
TODO_GROUPED = (
    "the per-pod grouped path (ops/grouped.py:schedule_group + "
    "kernels.schedule_batch) is not ported yet (ROADMAP Queue 1, item 4)"
)
TODO_SCAN = (
    "the light/micro scans (fast.py:light_scan, _light_scan_micro) are not "
    "ported yet (ROADMAP Queue 1, item 5)"
)
TODO_AFFINITY = (
    "inter-pod (anti-)affinity terms (the affinity branch of "
    "fast.py:domain_select and _light_eval) are not ported yet "
    "(ROADMAP Queue 1, item 5)"
)

# Channel layout of Trajectory.packed.
CH_CPU, CH_MEM, CH_RES_FAIL, CH_PORT_OK, CH_STO_OK, CH_GPU_OK = range(6)
CH_STO_RAW, CH_GPU_RAW = 6, 7
N_CH = 8

SP_IDX = WEIGHT_ORDER.index("topology_spread")
IPA_IDX = WEIGHT_ORDER.index("inter_pod_affinity")
assert SP_IDX == len(WEIGHT_ORDER) - 1 and IPA_IDX == SP_IDX - 1, (
    "the partial-sum splits need the carry-coupled terms LAST in the fold"
)


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
    any_coupled = (
        f.any_soft_spread or f.any_hard_spread or f.any_req_aff
        or f.any_pref_aff or f.any_anti_sym
    )
    domain_aff = (
        any_coupled and not f.dyn_gpu and not f.dyn_storage and keys_domainable
    )
    return f._replace(domain_aff=domain_aff)


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
    """traj_arr[n, x_n] for every node (0 where x_n is out of range). The
    +0.0 turns a -0.0 lane into +0.0, as the reference's one-hot sum does."""
    N, J = traj_arr.shape[:2]
    v = traj_arr[torch.arange(N, device=x.device), x.clamp(0, J - 1).long()]
    inb = ((x >= 0) & (x < J)).reshape((N,) + (1,) * (v.dim() - 1))
    return torch.where(inb, v, 0.0) + 0.0


def _la_ba(ns: NodeStatic, pod: PodRow, free2: torch.Tensor):
    """LeastAllocated + BalancedAllocation from cpu/mem free values (free2 is
    [N,2] or [N,J,2]; elementwise, so every lane matches the per-step
    plugins). The mean over two values is (a + b) * 0.5, the same rounding
    as jnp.mean's sum / 2."""
    alloc2 = ns.alloc[:, :2]
    req2 = pod.req[:2]
    if free2.dim() == 3:
        alloc2 = alloc2[:, None, :]
    free_after = free2 - req2
    frac = torch.where(alloc2 > 0, free_after / alloc2.clamp(min=1e-9), 0.0)
    la = ((frac[..., 0] + frac[..., 1]) * 0.5).clamp(0.0, 1.0) * 100.0
    used_after = alloc2 - free2 + req2
    frac_b = torch.where(alloc2 > 0, used_after / alloc2.clamp(min=1e-9), 0.0)
    frac_b = frac_b.clamp(0.0, 1.0)
    ba = (1.0 - (frac_b[..., 0] - frac_b[..., 1]).abs()) * 100.0
    return la, ba


def _lane_rows(ns: NodeStatic, traj: Trajectory, pod: PodRow, static_scores: dict) -> dict:
    """The node-local score rows per (node, lane), shared by the sort and
    domain paths. Assumes gpu_free is frozen for the group and no storage
    volumes / preferred affinity terms."""
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
    per-filter bools for first-fail attribution). Spread counts are
    reconstructed exactly as base + match * x."""
    if _any_affinity(flags):
        raise NotImplementedError(TODO_AFFINITY)
    N = ns.valid.shape[0]
    ones = torch.ones(N, dtype=torch.bool, device=x.device)
    xf = x.to(torch.float32)
    free2 = cur[:, CH_CPU:CH_MEM + 1]
    res_fail_x = (cur[:, CH_RES_FAIL] > 0.5) & fo[F_RESOURCES]
    port_ok = ((cur[:, CH_PORT_OK] > 0.5) | ~fo[F_NODE_PORTS]) if flags.dyn_ports else ones
    storage_ok = (cur[:, CH_STO_OK] > 0.5) if flags.dyn_storage else ones
    gpu_ok = (cur[:, CH_GPU_OK] > 0.5) if flags.dyn_gpu else ones

    rows = list(zip(
        pod.spread_topo.tolist(), pod.spread_sel.tolist(), pod.spread_hard.tolist()
    ))

    def srow(sel_idx):
        return carry0.sel_counts[sel_idx] + pod.match_sel[sel_idx].to(torch.float32) * xf

    spread_ok = ones
    if flags.any_hard_spread:
        for c, (k, s, hard) in enumerate(rows):
            if k < 0 or not hard:
                continue
            has_key = ns.topo[:, k] >= 0
            _, cnt_n, min_count, _ = _domain_counts(ns, srow(s), k, na_ok)
            ok_c = ((cnt_n + 1.0 - min_count) <= pod.spread_skew[c] + _EPS) & has_key
            spread_ok = spread_ok & ok_c
        spread_ok = spread_ok | ~fo[F_SPREAD]
    aff_ok = ones  # no affinity terms (raised above)

    mask = (
        static_ok & port_ok & ~res_fail_x & spread_ok & aff_ok & storage_ok
        & gpu_ok & ns.valid
    )
    la, ba = _la_ba(ns, pod, free2)
    if flags.any_soft_spread:
        raw_sp = torch.zeros(N, dtype=torch.float32, device=x.device)
        for k, s, hard in rows:
            if k >= 0 and not hard:
                raw_sp = raw_sp + _domain_counts(ns, srow(s), k, na_ok)[1]
        sp_score = _spread_norm(raw_sp, ns.valid)
    else:
        sp_score = torch.full((N,), 100.0, device=x.device)
    zeros = torch.zeros(N, dtype=torch.float32, device=x.device)
    by_name = {
        "balanced_allocation": ba,
        "least_allocated": la,
        "topology_spread": sp_score,
        "inter_pod_affinity": zeros,
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
    score = torch.where(mask, combine_scores(by_name, weights), float("-inf"))
    parts = {
        "port_ok": port_ok, "res_fail": res_fail_x, "spread_ok": spread_ok,
        "aff_ok": aff_ok, "storage_ok": storage_ok, "gpu_ok": gpu_ok,
    }
    return score, parts


def _hoisted_values(ns: NodeStatic, cur: torch.Tensor, flags: GroupFlags) -> dict:
    """Group-invariant values _light_eval needs: for a non-GPU group the
    gpu-share score is frozen at its entry value."""
    out = {}
    if not flags.dyn_gpu:
        out["gpu_score"] = _minmax_normalize(cur[:, CH_GPU_RAW], ns.valid)
    return out


def _sortable(flags: GroupFlags) -> bool:
    """Sort-path eligible: every score/mask is a function of the node's OWN
    commit count alone (no spread/affinity coupling, no GPU/storage)."""
    return not (
        flags.any_hard_spread or flags.any_soft_spread or flags.any_req_aff
        or flags.any_pref_aff or flags.any_anti_sym or flags.dyn_gpu
        or flags.dyn_storage
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
    score = torch.where(mask, combine_scores(by_name, weights), float("-inf"))
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


class SpreadTables(NamedTuple):
    """Loop-invariant spread-reconstruction tables of the domain path."""
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
    resources, the only dynamics a domain-eligible group has)."""
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


class DomainPlan(NamedTuple):
    """Host-built partition of nodes into combined (spread-domain-tuple,
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
    """Whole-group selection with an O(Dc) pop-loop state for spread-only
    domain groups (topology spread over non-hostname keys, no GPU/storage).

    Nodes of one combined class share every spread count, so within a class
    the pick order is the sort-path merge: one stable sort of all [N,J] lanes
    keyed (class, score desc) gives each class's head table. The pop loop
    (`domain_pop`, the CUDA kernel on the card) then scores only the Dc class
    heads per step.

    Returns (mono_ok, nodes i32[group_size], jidx i32[group_size], x i32[N])."""
    if _any_affinity(flags):
        raise NotImplementedError(TODO_AFFINITY)
    N, J, _ = traj.packed.shape
    dev = traj.packed.device
    fo = _filters_on(filter_on, dev)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    # partial8 lanes: the fold prefix BEFORE both coupled terms; with no
    # affinity term the pop loop's total is partial8 + w_sp * sp, as in the
    # reference's kernel
    p8, feas = _lane_partials(
        ns, traj, pod, static_scores, static_ok, weights, fo, prefix_end=IPA_IDX,
    )
    score_lane = torch.where(feas, p8, float("-inf"))
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
    hscore = torch.where(in_range, -sneg[gidx], float("-inf"))  # [Dc,L]
    hflat = sidx[gidx]
    hnode = (hflat // J).to(torch.int32)
    hj = (hflat % J).to(torch.int32)
    cap_eff = counts.clamp(max=l_cap).to(torch.int32)

    st = _spread_tables(ns, carry0, pod, na_ok, flags)
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
        flags, _hoisted_values(ns, cur, flags),
    )
    first_fail = torch.full_like(static_ff, NUM_FILTERS)
    for bad, f in (
        (~p["gpu_ok"], F_GPU), (~p["storage_ok"], F_STORAGE),
        (~p["aff_ok"], F_POD_AFFINITY), (~p["spread_ok"], F_SPREAD),
        (p["res_fail"], F_RESOURCES), (~p["port_ok"], F_NODE_PORTS),
    ):
        first_fail = torch.where(bad, f, first_fail)
    first_fail = torch.where(static_ff < NUM_FILTERS, static_ff, first_fail)
    return torch.zeros(NUM_FILTERS, dtype=torch.int32, device=x.device).index_add_(
        0, first_fail.clamp(0, NUM_FILTERS - 1).long(),
        ((first_fail < NUM_FILTERS) & ns.valid).to(torch.int32),
    )


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
    force_fast: bool = False,
    filter_on=None,
    device=DEFAULT_DEVICE,
    timings: Optional[dict] = None,
) -> Tuple[Carry, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Schedule a pod batch group by group through the trajectory fast path.

    Returns (carry, nodes i32[P], reasons i32[P,F], gpu_take i32[P,G],
    vg_take f32[P,V], dev_take f32[P,DV]), bit-identical to the JAX
    package's schedule_batch_fast. `ns`/`carry` must live on `device`.
    `force_fast` disables the amortization heuristic. `timings`, when given, accumulates wall seconds per phase (trajectory,
    select, tail), synchronizing the device at each phase boundary."""
    dev = resolve_device(device)
    if not _same_device(ns.valid.device, dev) or not _same_device(carry.free.device, dev):
        raise ValueError(
            f"state lives on {ns.valid.device}/{carry.free.device}, "
            f"but device={dev} was asked for"
        )
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    if filter_on is not None:
        filter_on = torch.as_tensor(filter_on, dtype=torch.bool).to(dev)
    P = batch.p
    nodes_out = np.full(P, -1, np.int32)
    reasons_out = np.zeros((P, NUM_FILTERS), np.int32)
    take_out = np.zeros((P, ns.gpu_total.shape[1]), np.int32)
    vg_out = np.zeros((P, ns.vg_cap.shape[1]), np.float32)
    dev_out = np.zeros((P, ns.dev_cap.shape[1]), np.float32)
    rows_all = pod_rows_from_batch(batch, dev)
    N = ns.valid.shape[0]
    valid_np = ns.valid.cpu().numpy()

    # a disabled NodeResourcesFit filter voids the trajectory-length bound
    res_filter_on = filter_on is None or bool(filter_on[F_RESOURCES])
    free_entry = carry.free.cpu().numpy() if res_filter_on else None
    anti_topo_np = ns.anti_topo.cpu().numpy()
    topo_np = ns.topo.cpu().numpy()
    n_domains = int(ns.topo_onehot.shape[1])

    clock = [time.perf_counter()]

    def phase(name):
        if timings is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        timings[name] = timings.get(name, 0.0) + now - clock[0]
        clock[0] = now

    for start, length in group_runs(batch):
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
        use_fast = (
            j_need is not None
            and _bucket_j(j_need) <= J_CAP
            and (force_fast or length >= max(3 * j_need // 2, 64))
        )
        if not use_fast:
            raise NotImplementedError(f"group at pod {start} (length {length}): {TODO_GROUPED}")

        j_steps = _bucket_j(j_need)
        traj, static_ok, static_ff, static_scores, na_ok = build_trajectory(
            ns, carry, row, weights, j_steps, filter_on, flags
        )
        phase("trajectory")
        out_size = _bucket_light(length)
        if _sortable(flags) and out_size <= N * j_steps:
            mono, nodes_d, jidx_d, x = sort_select(
                ns, traj, row, static_ok, static_scores, weights, length,
                out_size, filter_on,
            )
            if not bool(mono):
                raise NotImplementedError(
                    f"group at pod {start}: a score sequence rises (sort fallback); {TODO_SCAN}"
                )
            path = "sort"
        elif flags.domain_aff:
            if _any_affinity(flags):
                raise NotImplementedError(f"group at pod {start}: {TODO_AFFINITY}")
            elig_np = na_ok.cpu().numpy() & valid_np
            plan = _domain_plan(
                batch.spread_topo[start], batch.aff_topo[start], anti_topo_np,
                batch.match_anti[start], topo_np, valid_np, elig_np, j_steps,
                n_domains,
            )
            if plan is None:
                raise NotImplementedError(
                    f"group at pod {start}: more than DM_CAP={DM_CAP} domain classes; {TODO_SCAN}"
                )
            l_cap = _bucket_light(min(int(plan.counts.max()), length))
            launched = _dp.launches
            mono, nodes_d, jidx_d, x = domain_select(
                ns, traj, carry, row, static_ok, static_scores, na_ok, weights,
                plan, _bucket_light(length), l_cap, length, filter_on, flags,
            )
            if not bool(mono):
                raise NotImplementedError(
                    f"group at pod {start}: a lane sequence rises (domain fallback); {TODO_SCAN}"
                )
            path = "domain"
            PATH_COUNTS["domain_kernel"] += _dp.launches - launched
        else:
            raise NotImplementedError(f"group at pod {start}: {TODO_SCAN}")
        nodes_d, jidx_d = nodes_d[:length], jidx_d[:length]
        phase("select")

        take_d, vg_d, dev_d = gather_takes(traj, nodes_d, jidx_d)
        reason_d = light_reasons(
            ns, carry, row, static_ok, static_ff, static_scores, na_ok, weights,
            x, cur_at(traj, x), filter_on, flags,
        )
        carry = exit_carry(ns, carry, row, traj, x)
        sl = slice(start, start + length)
        nodes_np = nodes_d.cpu().numpy()
        nodes_out[sl] = nodes_np
        take_out[sl] = take_d.cpu().numpy().astype(np.int32)
        vg_out[sl] = vg_d.cpu().numpy()
        dev_out[sl] = dev_d.cpu().numpy()
        if (nodes_np < 0).any():
            # a failed step commits nothing: one reason row covers the suffix
            reasons_out[sl][nodes_np < 0] = reason_d.cpu().numpy()
        PATH_COUNTS[path] += 1
        phase("tail")

    return carry, nodes_out, reasons_out, take_out, vg_out, dev_out
